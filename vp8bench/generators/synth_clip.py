"""Inputs of an encode cell: a seeded synthetic YUV 4:2:0 clip, looped by
the driver. One generator for every clip; the traffic file sets its
layers (integer arithmetic throughout, so a seed gives the same clip on
any device):

  gradient  {"x", "y", "t", "div"}: luma ((x*col + y*row + t*frame) //
            div) % 255, a diagonal gradient moving t/div px per frame
            (t = 0: still);
  noise     amplitude a: a seeded, fixed field in [-a, a] added to it;
  squares   {"size", "period", "dx", "dy"}: a checkerboard of size-px
            cells (one in three, the pattern stepping every `period`
            frames) filled with a seeded random texture translating
            (dx, dy) px per frame;
  patches   [{"size", "x", "y", "dx", "dy"}]: squares of seeded random
            texture moving (dx, dy) px per frame, wrapping inside the
            frame;
  edge      {"width", "speed", "value"}: a vertical bar moving speed px
            per frame;
  chroma    {"u_x", "u_t", "v_y", "v_t"}: U = (u_x*2*col + u_t*frame) %
            255, V = (v_y*2*row + v_t*frame) % 255.

The seed sets only the random textures and the noise field: every seed
gives the same sizes and motion. `tools/make_test_vectors.synth_clip` of
the program made the source of tests/vectors/bench_1080p.ivf with the
layers of `traffic/synth_motion.json`.
"""
import numpy as np


def make(config, traffic, seed, device):
    import torch
    w, h, n = config["width"], config["height"], traffic["frames"]
    cw, ch = (w + 1) // 2, (h + 1) // 2
    rng = np.random.default_rng(seed % 2 ** 64)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=torch.int32)

    row = torch.arange(h, device=device, dtype=torch.int32)[:, None]
    col = torch.arange(w, device=device, dtype=torch.int32)[None, :]
    crow = torch.arange(ch, device=device, dtype=torch.int32)[:, None]
    ccol = torch.arange(cw, device=device, dtype=torch.int32)[None, :]
    g, sq, edge, chroma = (traffic.get(k) for k in ("gradient", "squares",
                                                      "edge", "chroma"))
    tex = dev(rng.integers(0, 256, (2 * h, 2 * w), np.uint8)) if sq else None
    a = traffic.get("noise", 0)
    noise = dev(rng.integers(-a, a + 1, (h, w))) if a else None
    patches = [(p, dev(rng.integers(0, 256, (p["size"], p["size"]),
                                    np.uint8)))
               for p in traffic.get("patches", [])]
    ys = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    us = torch.empty((n, ch, cw), dtype=torch.uint8, device=device)
    vs = torch.empty((n, ch, cw), dtype=torch.uint8, device=device)
    for t in range(n):
        y = ((g["x"] * col + g["y"] * row + g["t"] * t) // g["div"]) % 255
        if noise is not None:
            y = (y + noise).clamp(0, 255)
        if sq:
            ox, oy = (t * sq["dx"]) % w, (t * sq["dy"]) % h
            cells = (col // sq["size"] + row // sq["size"]
                     + t // sq["period"]) % 3 == 0
            y = torch.where(cells, tex[oy:oy + h, ox:ox + w], y)
        for p, ptex in patches:
            s = p["size"]
            x0 = (p["x"] + p["dx"] * t) % (w - s + 1)
            y0 = (p["y"] + p["dy"] * t) % (h - s + 1)
            y[y0:y0 + s, x0:x0 + s] = ptex
        if edge:
            e = (t * edge["speed"]) % max(1, w - 8)
            y[:, e:e + edge["width"]] = edge["value"]
        ys[t] = y
        us[t] = ((chroma["u_x"] * 2 * ccol + chroma["u_t"] * t) % 255
                 ).expand(ch, cw)
        vs[t] = ((chroma["v_y"] * 2 * crow + chroma["v_t"] * t) % 255
                 ).expand(ch, cw)
    ys, us, vs = (x.cpu().numpy() for x in (ys, us, vs))
    return {"width": w, "height": h,
            "frames": [(ys[t], us[t], vs[t]) for t in range(n)]}
