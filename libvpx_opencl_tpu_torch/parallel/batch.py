"""Checkpointable batch transcode driver: port of
libvpx_opencl_tpu/parallel/batch.py.

A corpus of IVF streams is partitioned over workers (shard_index of
shard_count takes every shard_count-th job); each worker transcodes its
jobs one by one and writes a JSON checkpoint after each, so a preempted
worker resumes where it stopped. The checkpoint keeps the JAX class's
keys: {"done": [names], "stats": {name: {"frames", "seconds",
"out_bytes"}}}.
"""
from __future__ import annotations

import json
import os
import time


class BatchTranscoder:
    def __init__(self, jobs, out_dir, checkpoint_path=None, qindex=32,
                 device="cuda", use_device=True, shard_index=0,
                 shard_count=1):
        """jobs: list of input IVF paths. Shard selection picks every
        shard_count-th job (the per-worker partition of the corpus).
        use_device=True transcodes with TorchDecoder and TorchEncoder on
        `device`; use_device=False with the host RefDecoder (native
        runtime) and Encoder (the JAX class's use_tpu=False)."""
        self.jobs = [j for i, j in enumerate(jobs)
                     if i % shard_count == shard_index]
        self.out_dir = out_dir
        self.ckpt = checkpoint_path or os.path.join(out_dir,
                                                    "transcode.ckpt.json")
        self.qindex = qindex
        self.device = device
        self.use_device = use_device
        self.state = {"done": [], "stats": {}}
        if os.path.exists(self.ckpt):
            with open(self.ckpt) as f:
                self.state = json.load(f)

    def _save(self):
        os.makedirs(self.out_dir, exist_ok=True)
        tmp = self.ckpt + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f)
        os.replace(tmp, self.ckpt)

    def _codecs(self, width, height):
        if self.use_device:
            from ..models.torch_decoder import TorchDecoder
            from ..models.torch_encoder import TorchEncoder
            return (TorchDecoder(device=self.device),
                    TorchEncoder(width, height, qindex=self.qindex,
                                 device=self.device))
        from ..models.encoder import Encoder
        from ..models.refdec import RefDecoder
        dec = type("D", (RefDecoder,), {"use_native": True})()
        return dec, Encoder(width, height, qindex=self.qindex)

    def run(self):
        from ..utils.ivf import IvfStream, read_ivf, write_ivf
        os.makedirs(self.out_dir, exist_ok=True)
        for job in self.jobs:
            name = os.path.basename(job)
            if name in self.state["done"]:
                continue
            t0 = time.time()
            src = read_ivf(job)
            dec, enc = self._codecs(src.width, src.height)
            out = IvfStream(width=src.width, height=src.height)
            n = 0
            for payload, pts in src.frames:
                show = dec.decode_frame_core(payload)
                if not show:
                    continue
                y, u, v = dec.frame_to_show.visible()
                out.frames.append((enc.encode_frame(y, u, v), pts))
                n += 1
            out_path = os.path.join(self.out_dir, name)
            write_ivf(out_path, out)
            self.state["done"].append(name)
            self.state["stats"][name] = {
                "frames": n,
                "seconds": round(time.time() - t0, 2),
                "out_bytes": os.path.getsize(out_path),
            }
            self._save()
        return self.state
