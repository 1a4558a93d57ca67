"""CPU tests of the benchmark harness (vp8bench/): its files resolve by
name, its generators are seeded, its rooflines count what they say, a run
without a card is refused, the references import nothing of the program,
and small runs on the CPU come out correct, while the controls and the
planted faults (tests/faults.py) make them come out not correct.

    python -m pytest vp8bench/tests -q
"""
import ast
import copy
import glob
import os
import subprocess
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from vp8bench.harness import bench, loader  # noqa: E402
from vp8bench.tests import faults  # noqa: E402

SPEC = loader.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


# -- small cells on the CPU ----------------------------------------------

#: a still clip for the encode faults (at 64x48 the motion clip's inter
#: frames are all intra, so a stale ring could not show): a still
#: gradient with noise, one textured patch moving 4 px per frame
STILL = {"gradient": {"x": 7, "y": 3, "t": 0, "div": 10}, "noise": 3,
         "squares": None, "edge": None,
         "patches": [{"size": 256, "x": 160, "y": 412, "dx": 4, "dy": 0}],
         "chroma": {"u_x": 1, "u_t": 0, "v_y": 2, "v_t": 0}}


def small(cell, **traffic):
    """The cell resolved from BENCHMARK.json, cut to a size the CPU runs
    in seconds: decode cells on tests/data/inter_qcif.ivf (10 frames,
    176x144), encode cells at 64x48 on a 12-frame clip. The content
    limits of a traffic file (bytes, B_PRED) belong to its full size and
    are left out."""
    c = bench.resolve(SPEC, cell)
    c["config"] = dict(c["config"])
    c["traffic"] = copy.deepcopy(dict(c["traffic"], **traffic))
    c["workload"] = dict(c["workload"], trace_frames=2)
    if c["config"]["check"] == "md5_frames":
        c["config"].update(
            stream=os.path.join(HERE, "data", "inter_qcif.ivf"),
            golden_md5=os.path.join(HERE, "data", "inter_qcif.ivf.md5"))
    else:
        c["config"].update(width=64, height=48)
        c["traffic"]["frames"] = 12
        for key in ("inter_bytes_limit", "bpred_free_samples_limit"):
            c["traffic"].pop(key, None)
        for p in c["traffic"].get("patches") or []:
            p.update(size=16, x=8, y=8)
        if c["traffic"].get("squares"):
            c["traffic"]["squares"] = dict(c["traffic"]["squares"], size=8)
    return c


def small_noblit():
    """The decode closed loop without readback (`closed_loop_noblit`,
    driver `decode_core`), which no cell runs yet, at the small size."""
    c = small("dec1080.api_readback")
    c["traffic"] = loader.data("traffic", "closed_loop_noblit")
    c["workload"] = dict(c["workload"], traffic="closed_loop_noblit",
                         driver="decode_core")
    return c


def run_small(cell, seed=7, seconds=1.0, trace=False, patch=None):
    logs = []
    r = bench.run(small(cell), seed, seconds, trace, time.perf_counter(),
                  device="cpu", patch=patch, log=logs.append)
    return r, logs


@pytest.mark.parametrize("cell", CELLS)
def test_small_run_is_correct(cell):
    r, logs = run_small(cell)
    assert r["correct"], (r["check"], logs)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "check"
    names = {m["name"] for m in SPEC["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == names
    assert all(m["value"] > 0 for m in r["metrics"].values())


def test_small_noblit_run_is_correct():
    logs = []
    r = bench.run(small_noblit(), 7, 1.0, False, time.perf_counter(),
                  device="cpu", log=logs.append)
    assert r["correct"], (r["check"], logs)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("cell", ["dec1080.api_readback",
                                  "enc1080.good.motion"])
def test_traced_small_run_reads_spans(cell):
    r, logs = run_small(cell, trace=True)
    assert r["correct"], (r["check"], logs)
    spans = {m["name"] for m in SPEC["per_layer"]
             if cell in m["workloads"] and m["source"] == "program_span"}
    assert spans and spans <= set(r["metrics"])
    # no device on the CPU: no roofline, no idle share, no busy time
    assert not any("roofline" in k or "idle" in k for k in r["metrics"])
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("noblit", f) for f in faults.FAULTS["decode"]] + [
    ("enc1080.good.still", f) for f in ("coarser_quantizer",
                                        "ring_unchanged", "half_left_out",
                                        "answer_altered")] + [
    ("dec1080.api_readback", "lf_skipped"),
    ("enc1080.good.motion", "coarser_quantizer")])
def test_control_and_faults_are_not_correct(cell, fault):
    """Every control and fault, on the decode loop without readback and
    on one encode cell (the encode faults on the still clip, STILL), and
    each control on the cells of its configuration. The speed-feature
    controls are the next test's."""
    if cell == "enc1080.good.still":
        c = small("enc1080.good.motion", **STILL)
    else:
        c = small_noblit() if cell == "noblit" else small(cell)
    patch = faults.FAULTS[faults.kind(c["config"])][fault]
    logs = []
    r = bench.run(c, 7, 1.0, False, time.perf_counter(), device="cpu",
                  patch=patch, log=logs.append)
    assert not r["correct"], (r["check"], logs)


def effort_cell(**limits):
    """The motion cell at 160x96, where the B_PRED search wins MBs in every
    inter frame and the step-2 search codes more residual, with the
    content limits given."""
    c = small("enc1080.good.motion")
    c["config"].update(width=160, height=96, check_samples=3)
    c["traffic"].update(frames=8, squares=dict(c["traffic"]["squares"],
                                               size=16), **limits)
    return c


def test_speed_feature_controls_are_not_correct():
    """cpu_used_1 codes more bytes per inter frame than the sound run;
    cpu_used_5 codes no B_PRED MB. Each fails the number held against it,
    with the limit put between the two readings at this size. The window
    is the first frame after the set-up's five, the same in every run."""
    logs = []
    sound = bench.run(effort_cell(), 7, 0.01, False, time.perf_counter(),
                      device="cpu", log=logs.append)
    assert sound["correct"], (sound["check"], logs)
    assert "inter_bytes_per_frame" not in sound["check"]
    base = [line for line in logs if "payload bytes each" in line]
    b0 = float(base[0].split(", ")[1].split(" payload")[0])
    c = effort_cell(inter_bytes_limit=b0 * 1.04, bpred_free_samples_limit=0)
    r = bench.run(c, 7, 0.01, False, time.perf_counter(), device="cpu",
                  log=logs.append)
    assert r["correct"], (r["check"], logs)
    r1 = bench.run(c, 7, 0.01, False, time.perf_counter(), device="cpu",
                   patch=faults.FAULTS["encode"]["cpu_used_1"],
                   log=logs.append)
    assert not r1["correct"]
    assert r1["check"]["inter_bytes_per_frame"]["value"] > b0 * 1.04
    r5 = bench.run(c, 7, 0.01, False, time.perf_counter(), device="cpu",
                   patch=faults.FAULTS["encode"]["cpu_used_5"],
                   log=logs.append)
    assert not r5["correct"]
    assert r5["check"]["bpred_free_samples"]["value"] > 0


# -- files found by name -------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_workload_files_name_what_exists(cell):
    c = bench.resolve(SPEC, cell)
    assert loader.exists("generators", c["traffic"]["generator"])
    assert loader.exists("drivers", c["workload"]["driver"])
    assert loader.exists("reference", c["config"]["check"])
    assert c["per_layer"]
    for m in c["per_layer"]:
        mod = loader.module("layer_metrics", m["name"])
        assert callable(mod.read)
        if hasattr(mod, "ROOFLINE"):
            assert loader.exists("roofline", mod.ROOFLINE)
    for m in c["end_to_end"]:
        assert m["name"] == "setup_s" or loader.exists("end_to_end",
                                                       m["name"])
    cfg = next(x for x in SPEC["configs"] if x["name"] == c["cell"]["config"])
    assert cfg["file"].startswith(SPEC["paths"][0] + "/")


def test_every_workload_file_is_a_cell():
    files = {os.path.basename(f)[:-5]
             for f in glob.glob(os.path.join(BENCH, "workloads", "*.json"))}
    assert files == set(CELLS)


# -- generators ----------------------------------------------------------

@pytest.mark.parametrize("traffic", ["synth_motion", "still"])
def test_generator_is_seeded(traffic):
    c = small("enc1080.good.motion")
    tr = dict(small("enc1080.good.motion", **(
        STILL if traffic == "still" else {}))["traffic"], frames=4)
    gen = loader.module("generators", tr["generator"])
    a, b, d = (gen.make(c["config"], tr, s, "cpu")["frames"]
               for s in (5, 5, 2 ** 40 + 5))

    def same(x, y):
        return all((p == q).all() for fx, fy in zip(x, y)
                   for p, q in zip(fx, fy))
    assert same(a, b) and not same(a, d)
    assert a[0][0].shape == (48, 64) and a[0][1].shape == (24, 32)


def test_stream_generator_reads_the_config_stream():
    c = bench.resolve(SPEC, "dec1080.api_readback")
    gen = loader.module("generators", "ivf_stream")
    got = gen.make(c["config"], c["traffic"], 1, "cpu")
    assert (got["width"], got["height"]) == (1920, 1080)
    assert len(got["payloads"]) == 30
    assert got == gen.make(c["config"], c["traffic"], 2, "cpu")


# -- rooflines: bytes and operations against hand counts ------------------

def test_roofline_k1_k2_k5_hand_counts():
    # 2x3 MBs: MB 0 intra B_PRED, MB 1 intra TM, the rest inter
    p = torch.zeros(6, 20, dtype=torch.int32)
    p[0, 0], p[0, 2], p[1, 0], p[1, 2] = 4, 1, 3, 1
    k1 = loader.module("roofline", "k1")
    assert k1.work((2, 3, p)) == (6 * 4 + 2 * (1536 + 80 + 384), 0)
    lf = torch.zeros(6, 8, dtype=torch.int32)
    lf[[0, 4, 5], 0] = 20
    k2 = loader.module("roofline", "k2")
    assert k2.work((2, 3, lf)) == (24 + 3 * (32 + 768), 0)
    e = torch.zeros(6, 10, dtype=torch.int32)
    e[0, 0], e[0, 2], e[3, 0], e[3, 2] = 4, 1, 0, 1
    k5 = loader.module("roofline", "k5")
    assert k5.work((2, 3, e)) == (240 + 2 * (1536 + 71 + 384 + 1700) + 64,
                                  0)


def test_roofline_k3_k6_hand_counts():
    k3 = loader.module("roofline", "k3")
    # a 100x200 plane, 5 MBs, range 2: 25 offsets; one 4-byte SAD
    # instruction per 4 pixels of each MB and offset
    assert k3.work((20000, 5, 2)) == (20000 + 5 * 1032 + 5 * 25 * 4,
                                      5 * 25 * 64)
    k6 = loader.module("roofline", "k6")
    eobs = torch.zeros(2, 25, dtype=torch.int32)
    eobs[0, 0] = 16          # Y block from position 1: 15 steps
    eobs[0, 24] = 3          # Y2 from 0: 3 steps
    eobs[1, 20] = 1          # a chroma block: 1 step
    assert k6.work(eobs) == (2 * 5024 + 6912 + 3 * 2115 + 8, 0)
    # the capture takes the eobs from K6's inputs: (coefs, q0, e0, ...)
    assert k6.capture(((None, None, eobs), None), {}) is eobs


# -- refusals and imports ------------------------------------------------

def test_run_without_a_card_is_refused():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "dec1080.api_readback", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode != 0
    assert "refused" in r.stderr
    assert not r.stdout.strip()


def test_banned_modules_compare_whole_top_level_names():
    assert "libvpx_opencl_tpu_torch" not in bench.banned_modules()
    sys.modules["jaxfoo"] = sys.modules["os"]
    try:
        assert "jaxfoo" not in bench.banned_modules()
    finally:
        del sys.modules["jaxfoo"]
    sys.modules["jax.numpy"] = sys.modules["os"]
    try:
        assert bench.banned_modules() == ["jax"]
    finally:
        del sys.modules["jax.numpy"]


def test_reference_imports_nothing_of_the_program():
    for file in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        tree = ast.parse(open(file).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] in ("numpy", "hashlib", "os",
                                              "pickle", "random",
                                              "multiprocessing",
                                              "concurrent", "__future__"), \
                    (file, name)
    code = ("import sys; sys.path.insert(0, %r); "
            "import vp8bench.reference.closed_loop, "
            "vp8bench.reference.md5_frames; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & {"libvpx_opencl_tpu_torch", "libvpx_opencl_tpu",
                         "jax", "torch"}


def test_reference_decoder_matches_the_golden_md5s():
    from vp8bench.harness.ivf import read_ivf
    from vp8bench.reference import md5_frames
    from vp8bench.reference.host_decoder import RefDecoder
    _, _, payloads = read_ivf(os.path.join(HERE, "data", "inter_qcif.ivf"))
    want = md5_frames.golden(
        {"golden_md5": os.path.join(HERE, "data", "inter_qcif.ivf.md5")})
    dec = RefDecoder()
    got = []
    for p in payloads[:4]:
        dec.decode_frame_core(p)
        got.append(md5_frames.frame_md5(*dec.frame_to_show.visible()))
    assert got == want[:4]
