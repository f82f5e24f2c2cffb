"""The port's machine model (src/repro_torch/launch/machine.py) against the
reference's (src/repro/launch/machine.py): one model dict through both
packages' ``MachineModel.from_dict``, and ``time``, ``breakdown``,
``collective``, ``calibrate`` and ``error`` on the same terms and records,
held to rtol 1e-12.  Then the port's own parts: the H100 instance's
data-sheet peaks and their one home, the route-keyed peaks, the launch
cost ``calibrate`` fits on the card's model, and the calibration cache."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest

from repro.launch import machine as jm
from repro_torch.kernels import autotune as at
from repro_torch.launch import machine as pm

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune.json"))
    at.reset()
    yield
    at.reset()


def _pair(model: "jm.MachineModel"):
    d = model.as_dict()
    return jm.MachineModel.from_dict(d), pm.MachineModel.from_dict(d)


TERMS = [
    dict(flops=2e12, hbm_bytes=8e9, steps=10, mxu_util=0.5),
    dict(flops=1e9, hbm_bytes=4e10, steps=1e4),
    dict(flops=4e13, hbm_bytes=1e6),
    dict(flops=1e10, hbm_bytes=1e9, comm_bytes=3e8, comm_steps=14),
]
MODELS = [jm.V5E, jm.CPU,
          jm.MachineModel(name="eff", mxu_flops={1: 4e14, 2: 2e14, 4: 1e14},
                          hbm_bw=8e11, step_overhead_s=3e-7, link_bw=4e10,
                          vmem_bytes=1 << 24,
                          mxu_eff={"float32": 0.7, "bfloat16": 0.9},
                          hbm_eff={"float32": 0.8}, link_eff={"float32": 0.5},
                          link_latency_s=2e-6)]


@pytest.mark.parametrize("model", MODELS, ids=lambda m: m.name)
@pytest.mark.parametrize("terms", TERMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_time_and_breakdown_match_the_reference(model, terms, dtype):
    jmod, pmod = _pair(model)
    jb = jmod.breakdown(jm.CostTerms(**terms), dtype)
    pb = pmod.breakdown(pm.CostTerms(**terms), dtype)
    assert jb["bound"] == pb["bound"]
    for key in ("compute_s", "memory_s", "step_s", "comm_s", "total_s"):
        np.testing.assert_allclose(pb[key], jb[key], rtol=RTOL)
    np.testing.assert_allclose(pmod.time(pm.CostTerms(**terms), dtype),
                               jmod.time(jm.CostTerms(**terms), dtype),
                               rtol=RTOL)


@pytest.mark.parametrize("model", MODELS, ids=lambda m: m.name)
@pytest.mark.parametrize("payload,axes", [(4 * 2**20, (8,)), (256.0, (256,)),
                                          (4 * 2**20, (16, 16)),
                                          (1e3, (2, 4))])
@pytest.mark.parametrize("algorithm", ["auto", "ring", "tree"])
def test_collective_matches_the_reference(model, payload, axes, algorithm):
    jmod, pmod = _pair(model)
    want = jmod.collective(payload, axes, "float32", algorithm)
    got = pmod.collective(payload, axes, "float32", algorithm)
    assert got["algorithm"] == want["algorithm"]
    for key in ("comm_bytes", "comm_steps", "comm_s"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL)


@pytest.mark.parametrize("n,payload", [(1, 4096.0), (8, 1024.0), (5, 3.0),
                                       (64, 1e6)])
def test_collective_cost_matches_the_reference(n, payload):
    for algo in ("ring", "tree"):
        assert pm.collective_cost(n, payload, algo) == \
            jm.collective_cost(n, payload, algo)
    with pytest.raises(ValueError):
        pm.collective_cost(4, 1.0, "butterfly")


def _records(seed: int, comm: bool) -> list[dict]:
    """Measured-looking records: a machine 4x slower on HBM and 2x on
    compute than V5E, with 5% noise, in f32 and bf16."""
    rng = np.random.default_rng(seed)
    slow = jm.MachineModel(name="slow", mxu_flops=jm.V5E.mxu_flops,
                           hbm_bw=jm.V5E.hbm_bw / 4,
                           step_overhead_s=jm.V5E.step_overhead_s,
                           link_bw=jm.V5E.link_bw / 3,
                           vmem_bytes=jm.V5E.vmem_bytes,
                           mxu_eff={"float32": 0.5, "bfloat16": 0.5})
    out = []
    for dtype in ("float32", "bfloat16"):
        for _ in range(6):
            t = dict(flops=float(rng.uniform(1e9, 1e13)),
                     hbm_bytes=float(rng.uniform(1e6, 1e10)),
                     steps=float(rng.integers(1, 1000)),
                     mxu_util=float(rng.uniform(0.25, 1.0)))
            if comm:
                t.update(comm_bytes=float(rng.uniform(1e5, 1e8)),
                         comm_steps=float(rng.integers(2, 20)))
            meas = slow.time(jm.CostTerms(**t), dtype)
            out.append(dict(t, dtype=dtype,
                            measured_s=meas * float(rng.uniform(0.95, 1.05))))
    return out


@pytest.mark.parametrize("model", MODELS, ids=lambda m: m.name)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("comm", [False, True])
def test_calibrate_and_error_match_the_reference(model, seed, comm):
    jmod, pmod = _pair(model)
    recs = _records(seed, comm)
    jfit, pfit = jmod.calibrate(recs), pmod.calibrate(recs)
    for key in ("mxu_eff", "hbm_eff", "link_eff"):
        j, p = getattr(jfit, key), getattr(pfit, key)
        assert j.keys() == p.keys()
        for dt in j:
            np.testing.assert_allclose(p[dt], j[dt], rtol=RTOL)
    assert pfit.source == jfit.source == "calibrated"
    assert pfit.step_overhead_s == jfit.step_overhead_s
    np.testing.assert_allclose(pmod.error(recs), jmod.error(recs), rtol=RTOL)
    np.testing.assert_allclose(pfit.error(recs), jfit.error(recs), rtol=RTOL)
    assert pfit.error(recs) < pmod.error(recs)


def test_calibrate_needs_two_records_a_dtype():
    recs = _records(3, False)[:1]
    jmod, pmod = _pair(jm.V5E)
    assert pmod.calibrate(recs).mxu_eff == jmod.calibrate(recs).mxu_eff == {}


@pytest.mark.parametrize("model", [pm.H100, pm.CPU], ids=lambda m: m.name)
def test_as_dict_round_trips(model):
    back = pm.MachineModel.from_dict(json.loads(json.dumps(model.as_dict())))
    assert back == model


def test_h100_carries_the_data_sheet_peaks():
    """NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3; 67 TFLOP/s f32 on the
    CUDA cores; 495 TF32, 989 bf16 and 1979 int8 dense on the tensor cores;
    exponentials at a sixteenth of the f32 rate; 227 KB of shared memory a
    block; NVLink 4 at 450 GB/s a direction."""
    h = pm.H100
    assert h.hbm_bw == 3.35e12
    assert h.mxu_flops == {1: 1979e12, 2: 989e12, 4: 67e12}
    assert h.route_flops == {"fma": 67e12, "tf32": 495e12, "bf16": 989e12,
                             "int8": 1979e12, "exp": 67e12 / 16}
    assert h.vmem_bytes == 227 * 1024 == 232448
    assert h.link_bw == 450e9 and h.sms == 132
    assert h.step_overhead_s == 0.0 and h.source == "builtin"
    assert h.mxu_eff == h.hbm_eff == {}


@pytest.mark.parametrize("route,dtype,peak", [
    ("", "float32", 67e12), ("", "bfloat16", 989e12), ("", "int8", 1979e12),
    ("fma", "bfloat16", 67e12), ("tf32", "float32", 495e12),
    ("exp", "float32", 67e12 / 16), ("bf16", "bfloat16", 989e12)])
def test_peaks_follow_the_route(route, dtype, peak):
    """The route, not the dtype, sets the peak: bf16 storage on the CUDA
    cores runs at the f32 FMA rate, f32 on 3xTF32 at the TF32 rate."""
    assert pm.H100.peak_flops_raw(dtype, route) == peak
    t = pm.CostTerms(flops=1e12, route=route)
    assert pm.H100.breakdown(t, dtype)["compute_s"] == pytest.approx(
        1e12 / peak, rel=1e-15)


def _literal_peaks(path: Path) -> list:
    peaks = {3.35e12, 67e12, 495e12, 989e12, 1979e12}
    return [n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and n.value in peaks]


@pytest.mark.parametrize("name", ["chip_smoke.py"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "tools").glob("time_*.py")))
def test_peaks_have_one_home(name):
    """chip_smoke.py's and tools/'s bounds import the peaks from the
    machine model and keep no copy."""
    path = ROOT / name
    assert _literal_peaks(path) == [], name
    text = path.read_text()
    if "_PER_S" in text or "FLOPS" in text:
        assert "repro_torch.launch" in text and "machine" in text, name


def test_calibrate_fits_the_launch_cost_on_the_h100_model():
    """On a model whose launch cost is unknown (0, the built-in H100) the
    fit takes it from records that span several launch counts."""
    true = pm.MachineModel.from_dict(dict(
        pm.H100.as_dict(), step_overhead_s=5e-6,
        mxu_eff={"float32": 0.6}, hbm_eff={"float32": 0.8}))
    rng = np.random.default_rng(0)
    recs = []
    for _ in range(12):
        t = dict(flops=float(rng.uniform(1e8, 1e12)),
                 hbm_bytes=float(rng.uniform(1e6, 1e9)),
                 steps=float(rng.integers(1, 4)), route="fma")
        recs.append(dict(t, dtype="float32",
                         measured_s=true.time(pm.CostTerms(**t), "float32")))
    fit = pm.H100.calibrate(recs)
    assert fit.step_overhead_s == pytest.approx(5e-6, rel=0.3)
    assert fit.error(recs) < pm.H100.error(recs)
    # One launch count: nothing to tell a launch from the rest.
    same = [dict(r, steps=1.0) for r in recs]
    assert pm.H100.calibrate(same).step_overhead_s == 0.0


def test_calibration_cache_and_backend_lookup(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    assert pm.calibration_path() == path.with_name("machine.json")
    assert pm.for_backend("cuda") is pm.H100
    assert pm.for_backend("cpu") is pm.H100      # the card's decisions
    fit = pm.CPU.calibrate(_records(0, False))
    pm.save_calibration("cpu", fit)
    got = pm.for_backend("cpu")
    assert got.source == "calibrated" and got.hbm_eff == fit.hbm_eff
    assert pm.for_backend("cpu", prefer_calibrated=False) is pm.H100
    assert pm.for_backend("cuda") is pm.H100
    saved = json.loads(pm.calibration_path().read_text())
    assert set(saved["backends"]) == {"cpu"}
    assert pm.builtin("cuda") is pm.H100 and pm.builtin("cpu") is pm.CPU


def test_dtype_names():
    import torch
    assert pm.dtype_name(torch.bfloat16) == "bfloat16"
    assert pm.dtype_name("torch.float32") == "float32"
    assert pm.dtype_name(np.float32) == "float32"
    assert pm.itemsize("int8") == 1
    with pytest.raises(TypeError):
        pm.dtype_name("float128")
