"""The benchmark's general code: loading by name, the measured window,
spans, the profiled tail and the result line."""
