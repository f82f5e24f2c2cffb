"""The port's fault tolerance against the reference's, on the CPU.

Counterparts of tests/test_fault_tolerance.py's solver half (the shard
monitor, checkpoint hardening, the elastic solves, serving degradation)
and of tests/test_telemetry.py's traced requests: each runs the same numpy
inputs and the same seeded FaultPlan through the reference
(src/repro, JAX on the CPU) and the port (device="cpu"), with the
reference's tolerances (5e-4 against the clean solve, 1e-3 against
lstsq).  Within the port a resumed or retried solve must give the same
bits as the undisturbed one.  The multi-rank cases run on 4 gloo CPU
ranks (rank bodies in tests/torch_fault_cases.py), against the
reference's clean solve on one device.
"""
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.optim import elastic as jel
from repro.core.tfocs.linop import LinopMatrix as JLinopMatrix
from repro.launch import serve as jserve
from repro.train import checkpoint as jckpt
from repro.train import faults as jfaults
from repro.train import straggler as jstraggler
from repro_torch import api
from repro_torch.core.distmat import RowMatrix
from repro_torch.core.distmat import types as T
from repro_torch.core.optim import batched
from repro_torch.core.optim.elastic import (ElasticConfig, ElasticGroup,
                                            SolveCheckpoint, solve_elastic)
from repro_torch.core.tfocs.linop import LinopMatrix
from repro_torch.launch import planner
from repro_torch.launch import telemetry as tel
from repro_torch.launch.serve import GroupRunner, SolverServer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.faults import (FaultPlan, FaultyLinop, FaultyMesh,
                                      TransientShardError)
from repro_torch.train.straggler import (ShardMonitor, StepMonitor,
                                         StragglerConfig)

CLEAN_TOL, LSTSQ_TOL = 5e-4, 1e-3      # tests/test_fault_tolerance.py's
RECOVERY_KEYS = ("converged", "degraded", "retries", "remeshes",
                 "checkpoint_saves", "resumed_from")
MONITOR = dict(warmup_steps=2, threshold=2.0, trip_limit=2)


def _nosleep(_dt):
    """In place of time.sleep: faults without the wall time."""


def _lstsq_setup(m=120, n=10, seed=21):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    b = (A @ rng.normal(size=n) + 0.01 * rng.normal(size=m)) \
        .astype(np.float32)
    return A, b, np.linalg.lstsq(A, b, rcond=None)[0]


def _port(A):
    return LinopMatrix(RowMatrix.create(A, device="cpu"))


def _ref(A):
    return JLinopMatrix(jnp.asarray(A))


def _maxabs(x, y) -> float:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return float(np.max(np.abs(x - np.asarray(y))))


def _same_recovery(info, jinfo):
    for key in RECOVERY_KEYS:
        assert info[key] == jinfo[key], (key, info[key], jinfo[key])


# -- the monitors ---------------------------------------------------------------

SEQUENCES = {
    "slow_shard": [[0.1] * 4] * 6 + [[0.1, 0.1, 0.5, 0.1]] * 2,
    "uniform_slowdown": [[0.1] * 4] * 6 + [[0.5] * 4] * 4,
    "single_shard": [[0.1]] * 6 + [[0.5]] * 2,
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_shard_monitor_matches_reference(name):
    """ShardMonitor's verdicts, iteration by iteration, equal the
    reference's (it names shard 2; a uniform slowdown never trips; one
    shard falls back to its own trip)."""
    seq = SEQUENCES[name]
    cfg = StragglerConfig(**MONITOR)
    mon = ShardMonitor(len(seq[0]), cfg)
    jmon = jstraggler.ShardMonitor(len(seq[0]),
                                   jstraggler.StragglerConfig(**MONITOR))
    verdicts = [mon.observe(t) for t in seq]
    assert verdicts == [jmon.observe(t) for t in seq]
    last = verdicts[-1]
    if name == "uniform_slowdown":
        assert not any(v["tripped"] for v in verdicts)
    else:
        assert last["tripped"]
        assert last["shard"] == (2 if name == "slow_shard" else 0)
        assert not verdicts[-2]["tripped"]


def test_shard_monitor_reset_forgets_history():
    mon = ShardMonitor(4, StragglerConfig(**MONITOR))
    for _ in range(6):
        mon.observe([0.1] * 4)
    mon.reset(3)
    assert mon.nshards == 3
    assert not mon.observe([0.5, 0.5, 0.5])["tripped"]   # fresh warmup


def test_straggler_monitor():
    mon = StepMonitor(StragglerConfig(warmup_steps=2, threshold=2.0,
                                      trip_limit=2))
    fired = []
    mon.on_straggler = fired.append
    for _ in range(6):
        mon.observe(0.10)
    v = mon.observe(0.50)                 # 5× EMA → flagged
    assert v["flagged"] and not v["tripped"]
    v = mon.observe(0.50)                 # second consecutive → tripped
    assert v["tripped"] and fired
    assert mon.ema == pytest.approx(0.10, rel=0.05)   # outliers not learnt


def test_straggler_deadline():
    mon = StepMonitor(StragglerConfig(deadline_s=0.2, warmup_steps=0,
                                      trip_limit=99))
    v = mon.observe(0.5)
    assert v["deadline_exceeded"] and v["tripped"]


def test_monitor_trips_reach_telemetry():
    with tel.recording() as rec:
        mon = ShardMonitor(4, StragglerConfig(**MONITOR))
        for t in SEQUENCES["slow_shard"]:
            mon.observe(t)
    assert rec.counter("straggler.trips").value == 1
    assert rec.gauge("straggler.ema_s", shard=2).value \
        == pytest.approx(0.1)


# -- checkpoints ------------------------------------------------------------------

def _gra_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    st = batched.gra_group_init(3, 5, device="cpu")
    return st._replace(X=torch.randn(3, 5, generator=g),
                       F=torch.randn(3, generator=g),
                       k=torch.tensor([4, 0, 7], dtype=torch.int32),
                       done=torch.tensor([True, False, True]))


def test_checkpoint_roundtrip(tmp_path):
    """A tree of tensors (a NamedTuple state with f32, int32 and bool
    fields, a bf16 leaf, a numpy mask) comes back bit for bit, each leaf
    in its tree_like leaf's dtype and on its device."""
    state = _gra_state()
    tree = {"state": state, "active": np.array([True, False, True]),
            "half": torch.linspace(-3, 3, 7).to(torch.bfloat16)}
    d = ckpt.save(tmp_path, 1, tree, extra={"data_step": 1})
    assert (d / "manifest.json").exists() and d.name == "step_00000001"
    assert ckpt.latest_step(tmp_path) == 1
    like = {"state": batched.gra_group_init(3, 5, device="cpu"),
            "active": np.zeros(3, bool),
            "half": torch.zeros(7, dtype=torch.bfloat16)}
    back, extra = ckpt.restore(tmp_path, like)
    assert extra["data_step"] == 1
    for a, b in zip(state, back["state"]):
        assert a.dtype == b.dtype
        assert a.numpy().tobytes() == b.numpy().tobytes()   # NaNs too
    assert torch.equal(back["half"], tree["half"])
    np.testing.assert_array_equal(back["active"], tree["active"])


def test_reference_reads_the_ports_checkpoint(tmp_path):
    """The on-disk layout and leaf names are the reference's: its restore
    reads what the port wrote."""
    state = _gra_state(seed=3)
    ckpt.save(tmp_path, 7, {"state": state, "active": np.ones(3, bool)},
              extra={"iteration": 7})
    jlike = {"state": jel._batched.gra_group_init(3, 5),
             "active": np.zeros(3, bool)}
    assert jckpt.latest_step(tmp_path) == 7
    back, extra = jckpt.restore(tmp_path, jlike)
    assert extra == {"iteration": 7}
    for a, b in zip(state, back["state"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_async_checkpoint(tmp_path):
    saver = ckpt.AsyncCheckpointer(tmp_path)
    state = _gra_state()
    saver.save_async(5, {"state": state}, extra={"data_step": 5})
    # The host copy is taken at the call: changing the tensors afterwards
    # does not change what lands on disk.
    state.X.zero_()
    saver.wait()
    assert ckpt.latest_step(tmp_path) == 5
    back, _ = ckpt.restore(tmp_path, {"state": _gra_state(seed=9)})
    assert torch.equal(back["state"].X, _gra_state().X)


def test_async_write_error_surfaces_on_next_save(tmp_path):
    """A background write failure is raised at the NEXT save_async (or
    wait), once, never dropped."""
    blocker = tmp_path / "ckpt"
    blocker.write_text("not a directory")
    saver = ckpt.AsyncCheckpointer(blocker)
    saver.save_async(1, {"a": torch.zeros(3)})
    with pytest.raises(OSError):
        saver.save_async(2, {"a": torch.zeros(3)})
    saver.wait()                               # cleared: no re-raise


def test_latest_step_skips_partial_checkpoint(tmp_path):
    """A torn checkpoint (manifest present, shard data missing) is never
    picked up, even when a stale LATEST names it."""
    ckpt.save(tmp_path, 1, {"a": torch.arange(3, dtype=torch.float32)})
    partial = tmp_path / "step_00000002"
    partial.mkdir()
    (partial / "manifest.json").write_text("{}")
    (tmp_path / "LATEST").write_text(partial.name)
    (tmp_path / ".tmp_step_00000003").mkdir()
    assert ckpt.latest_step(tmp_path) == 1
    tree, _ = ckpt.restore(tmp_path, {"a": torch.zeros(3)})
    assert torch.equal(tree["a"], torch.arange(3, dtype=torch.float32))


def test_checkpoint_write_spans_and_counters(tmp_path):
    with tel.recording() as rec:
        ckpt.save(tmp_path / "a", 1, {"a": torch.zeros(3)})
        saver = ckpt.AsyncCheckpointer(tmp_path / "b")
        saver.save_async(2, {"a": torch.zeros(3)})
        saver.wait()
    assert [s.name for s in rec.spans].count("checkpoint.write") == 2
    assert rec.counter("checkpoint.async_saves").value == 1
    assert rec.gauge("checkpoint.backlog").value == 0
    assert rec.histogram("checkpoint.write_s").count == 2


# -- elastic solves, port against reference ---------------------------------------

def _jsharded(A):
    """The reference's RowMatrix on a one-device mesh (its
    test_fault_tolerance._sharded on one device) and that mesh."""
    from repro.core.distmat import RowMatrix as JRowMatrix
    from repro.core.distmat.types import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"))
    return JLinopMatrix(JRowMatrix.create(jnp.asarray(A), mesh)), mesh


def test_straggler_detected_remesh_matches_clean_solve():
    """A shard that starts straggling mid-solve is detected, the matrix is
    re-meshed without restarting, and the solve matches the clean one and
    the reference's run of the same plan."""
    A, b, ref = _lstsq_setup()
    kw = dict(tol=1e-7, max_iters=400)
    plan = dict(shard_delays={0: 0.2}, delay_from=6)
    x_clean, info_clean = solve_elastic(_port(A), "quad", b, **kw)
    assert info_clean["converged"] and info_clean["remeshes"] == 0
    lin = FaultyLinop(_port(A), FaultPlan(**plan), sleep=_nosleep)
    fm = FaultyMesh(T.single_device_mesh("cpu"))
    x, info = solve_elastic(lin, "quad", b, elastic=ElasticConfig(
        monitor=ShardMonitor(1, StragglerConfig(**MONITOR)),
        remesh_to=fm.drop), **kw)

    jlin0, jmesh = _jsharded(A)
    jx_clean, _ = jel.solve_elastic(jlin0, "quad", b, **kw)
    jfm = jfaults.FaultyMesh(jmesh)
    _, jinfo = jel.solve_elastic(
        jfaults.FaultyLinop(jlin0, jfaults.FaultPlan(**plan),
                            sleep=_nosleep), "quad", b,
        elastic=jel.ElasticConfig(
            monitor=jstraggler.ShardMonitor(
                1, jstraggler.StragglerConfig(**MONITOR)),
            remesh_to=jfm.drop), **kw)
    _same_recovery(info, jinfo)
    assert info["converged"] and info["degraded"] is None
    assert info["remeshes"] >= 1 and fm.casualties == [0] == jfm.casualties
    assert lin.dropped == [0] and not lin.delays
    assert _maxabs(x, x_clean) < CLEAN_TOL
    assert _maxabs(x, jx_clean) < CLEAN_TOL
    assert _maxabs(x, ref) < LSTSQ_TOL


def test_device_loss_remesh_iterations_monotone():
    """DeviceLostError mid-solve: re-mesh, continue; the iteration counter
    advances by at most one a step and never rewinds."""
    A, b, ref = _lstsq_setup(seed=22)
    lin = FaultyLinop(_port(A), FaultPlan(lose_shard_at=3, lost_shard=0),
                      sleep=_nosleep)
    fm = FaultyMesh(T.single_device_mesh("cpu"))
    grp = ElasticGroup(lin, "quad", slots=1,
                       elastic=ElasticConfig(remesh_to=fm.drop))
    grp.admit_slot(b, tol=1e-7)
    ks = [0]
    while not bool(grp.state.done[0]) and ks[-1] < 400:
        grp.step_iteration()
        k = int(grp.state.k[0])
        assert k - ks[-1] in (0, 1) and k >= ks[-1]
        ks.append(k)
    assert grp.remeshes == 1 and fm.casualties == [0] and not grp.dropped
    assert bool(grp.state.done[0])
    assert _maxabs(grp.state.X[0], ref) < LSTSQ_TOL


@pytest.mark.parametrize("method", ["gra", "lbfgs"])
def test_transient_fault_retry_is_bit_exact(method):
    """A failed pass and a NaN-poisoned reduction roll back and retry; the
    retried iteration recomputes the same step, so the trajectory is bit
    for bit the fault-free one, with the reference's retry count."""
    A, b, _ = _lstsq_setup(seed=23)
    kw = dict(tol=0.0, max_iters=30, method=method)
    x_clean, _ = solve_elastic(_port(A), "quad", b, **kw)
    plan = dict(fail_steps=(3,), nan_steps=(7,))
    lin = FaultyLinop(_port(A), FaultPlan(**plan), sleep=_nosleep)
    x, info = solve_elastic(lin, "quad", b, elastic=ElasticConfig(
        backoff_s=1e-4, sleep=_nosleep), **kw)
    jlin = jfaults.FaultyLinop(_ref(A), jfaults.FaultPlan(**plan),
                               sleep=_nosleep)
    jx, jinfo = jel.solve_elastic(jlin, "quad", b, elastic=jel.ElasticConfig(
        backoff_s=1e-4, sleep=_nosleep), **kw)
    assert info["retries"] == 2 and info["iterations"] == 30
    _same_recovery(info, jinfo)
    assert torch.equal(x, x_clean)
    assert _maxabs(x, jx) < CLEAN_TOL


def test_retries_exhausted_raises():
    A, b, _ = _lstsq_setup(seed=24)

    class AlwaysFailing(FaultyLinop):
        def fault_hook(self, step, state, dt):
            raise TransientShardError("permanent injected fault")

    slept = []
    cfg = ElasticConfig(max_retries=2, backoff_s=0.01, sleep=slept.append)
    with tel.recording() as rec, pytest.raises(TransientShardError):
        solve_elastic(AlwaysFailing(_port(A)), "quad", b, tol=0.0,
                      max_iters=10, elastic=cfg)
    assert slept == [0.01, 0.02]               # exponential backoff
    assert rec.counter("solver.retries").value == 3


@pytest.mark.parametrize("method", ["gra", "lbfgs"])
def test_checkpoint_resume_is_bit_exact(tmp_path, method):
    """Kill a checkpointed solve mid-run, resume from its snapshot: it
    continues from the saved iteration and ends bit for bit where an
    undisturbed solve does (the L-BFGS memory and the int and bool fields
    round-trip exactly); the counters are the reference's."""
    A, b, _ = _lstsq_setup(seed=25)
    kw = dict(tol=0.0, method=method)

    def ck(d):
        return ElasticConfig(checkpoint=SolveCheckpoint(
            tmp_path / d, every=5, async_save=False))

    x_full, info_full = solve_elastic(_port(A), "quad", b, max_iters=40,
                                      elastic=ck("full"), **kw)
    assert info_full["checkpoint_saves"] == 8
    solve_elastic(_port(A), "quad", b, max_iters=20, elastic=ck("cut"), **kw)
    x2, i2 = solve_elastic(_port(A), "quad", b, max_iters=40, resume=True,
                           elastic=ck("cut"), **kw)
    assert i2["resumed_from"] == 20 and i2["iterations"] == 40
    assert i2["a_passes"] == info_full["a_passes"]
    assert torch.equal(x2, x_full)

    jck = jel.SolveCheckpoint(tmp_path / "jcut", every=5, async_save=False)
    jel.solve_elastic(_ref(A), "quad", b, max_iters=20,
                      elastic=jel.ElasticConfig(checkpoint=jck), **kw)
    jx2, ji2 = jel.solve_elastic(
        _ref(A), "quad", b, max_iters=40, resume=True,
        elastic=jel.ElasticConfig(checkpoint=jel.SolveCheckpoint(
            tmp_path / "jcut", every=5, async_save=False)), **kw)
    _same_recovery(i2, ji2)
    assert i2["iterations"] == ji2["iterations"]
    assert _maxabs(x2, jx2) < CLEAN_TOL


def test_async_checkpointed_solve_resumes(tmp_path):
    """The default async writer: snapshots land durably (wait() at the
    solve's end) and the solve resumes from the newest."""
    A, b, _ = _lstsq_setup(seed=26)
    ck = SolveCheckpoint(tmp_path, every=4)
    solve_elastic(_port(A), "quad", b, tol=0.0, max_iters=12,
                  elastic=ElasticConfig(checkpoint=ck))
    assert ck.latest() == 12 and ck.saves == 3
    _, info = solve_elastic(
        _port(A), "quad", b, tol=0.0, max_iters=16, resume=True,
        elastic=ElasticConfig(checkpoint=SolveCheckpoint(tmp_path, every=4)))
    assert info["resumed_from"] == 12 and info["iterations"] == 16


def test_deadline_returns_best_iterate():
    """A solve that cannot finish inside its wall budget returns its best
    iterate with converged=False and degraded='deadline'."""
    A, b, _ = _lstsq_setup(seed=27)
    lin = FaultyLinop(_port(A), FaultPlan(shard_delays={0: 0.02}))
    x, info = solve_elastic(lin, "quad", b, tol=0.0, max_iters=500,
                            deadline_s=0.1, elastic=ElasticConfig())
    assert info["degraded"] == "deadline" and not info["converged"]
    assert 0 < info["iterations"] < 500 and info["deadline_s"] == 0.1
    assert bool(torch.isfinite(x).all())


def test_api_routes_checkpointed_request(tmp_path):
    """SolveRequest(checkpoint_dir=..., resume=True) reaches the elastic
    path through api.solve, with the reference's counters."""
    A, b, _ = _lstsq_setup(seed=28)
    out = {}
    for side, mod, kw in (("port", api, dict(device="cpu")),
                          ("ref", japi, {})):
        d = tmp_path / side
        first = mod.solve(mod.SolveRequest(
            A=A, b=b, loss="quad", tol=0.0, max_iters=10,
            checkpoint_dir=str(d), checkpoint_every=5, **kw))
        res = mod.solve(mod.SolveRequest(
            A=A, b=b, loss="quad", tol=0.0, max_iters=20,
            checkpoint_dir=str(d), checkpoint_every=5, resume=True, **kw))
        out[side] = (first, res)
    (first, res), (jfirst, jres) = out["port"], out["ref"]
    assert first.info["plan"] == "elastic"
    assert first.info["checkpoint_saves"] == jfirst.info["checkpoint_saves"]
    _same_recovery(res.info, jres.info)
    assert res.info["resumed_from"] == 10 and res.info["iterations"] == 20
    assert {"iterations", "a_passes", "converged", "plan", "degraded",
            "precision"} <= set(res.info)
    assert _maxabs(res.x, jres.x) < CLEAN_TOL


# -- serving degradation ----------------------------------------------------------

def test_request_validation():
    A, b = np.eye(4, dtype=np.float32), np.ones(4, np.float32)
    for kw in ({"deadline_s": -1.0}, {"deadline_s": float("nan")},
               {"resume": True}, {"checkpoint_dir": "ck", "method": "acc"},
               {"checkpoint_dir": "ck", "prox": object()}):
        with pytest.raises(ValueError) as jerr:
            japi.SolveRequest(A=A, b=b, loss="quad", **kw)
        with pytest.raises(ValueError) as err:
            api.SolveRequest(A=A, b=b, loss="quad", device="cpu", **kw)
        assert str(err.value) == str(jerr.value)


def test_deadline_expiry_retires_slot_not_group():
    """An expired resident retires with its best iterate; its co-resident
    solves on unharmed."""
    A, b, ref = _lstsq_setup(seed=29)
    srv = SolverServer(slots=2)
    doomed = srv.submit(api.SolveRequest(
        A=A, b=b, loss="quad", tol=0.0, max_iters=10_000, deadline_s=1e-6,
        device="cpu"))
    healthy = srv.submit(api.SolveRequest(
        A=A, b=b, loss="quad", tol=1e-7, max_iters=400, device="cpu"))
    srv.run()
    r = srv.result(doomed)
    assert r.info["degraded"] == "deadline" and not r.info["converged"]
    assert r.info["iterations"] < 10_000
    h = srv.result(healthy)
    assert h.info["converged"] and h.info["degraded"] is None
    assert _maxabs(h.x, ref) < LSTSQ_TOL


def test_oneshot_expired_in_queue_not_run():
    """A one-shot whose deadline passed while it waited in the queue is
    answered degraded at dequeue, without a pass; one with time left runs
    with its deadline honoured."""
    A, b, _ = _lstsq_setup(seed=32)
    srv = SolverServer(slots=1)
    rid = srv.submit(api.SolveRequest(A=A, b=b, loss="quad", method="acc",
                                      max_iters=50, deadline_s=1e-9,
                                      device="cpu"))
    ok = srv.submit(api.SolveRequest(A=A, b=b, loss="quad", method="acc_b",
                                     max_iters=50, deadline_s=60.0,
                                     device="cpu"))
    time.sleep(0.01)
    srv.run()
    r = srv.result(rid)
    assert r.info["degraded"] == "deadline"
    assert r.info["plan"] == "expired" and r.info["a_passes"] == 0
    assert srv.result(ok).info["degraded"] != "deadline"
    assert srv.result(ok).info["iterations"] == 50
    assert srv.stats["expired"] == 1 and srv.stats["oneshot"] == 1


def test_injected_fault_beyond_retries_degrades_residents():
    """When recovery is exhausted the residents get their best iterates
    back (degraded='fault') and the serving loop survives."""
    A, b, _ = _lstsq_setup(seed=33)

    class AlwaysFailing(FaultyLinop):
        def fault_hook(self, step, state, dt):
            if step >= 2:
                raise TransientShardError("injected permanent fault")
            return state, None

    runner = GroupRunner(AlwaysFailing(_port(A)), "quad", slots=2,
                         elastic=ElasticConfig(max_retries=1,
                                               backoff_s=1e-4,
                                               sleep=_nosleep))
    for _ in range(2):
        runner.admit(api.SolveRequest(A=A, b=b, loss="quad", tol=0.0,
                                      max_iters=50, device="cpu"))
    out = []
    while runner.busy():
        out.extend(runner.step())
    assert len(out) == 2
    for r in out:
        assert r.info["degraded"] == "fault" and not r.info["converged"]
        assert r.info["iterations"] == 2          # its best iterate
        assert "injected permanent fault" in r.info["error"]
        assert bool(torch.isfinite(r.x).all())


def test_server_with_elastic_factory_straggler_recovers():
    """A served group hit by a mid-solve straggler re-meshes and still
    answers correctly, and the scheduler prices the group again; the
    reference's server does the same on the same plan."""
    A, b, ref = _lstsq_setup(seed=34)
    out = {}
    for side in ("port", "ref"):
        if side == "port":
            mat = RowMatrix.create(A, device="cpu")
            fm = FaultyMesh(T.single_device_mesh("cpu"))
            mk = lambda: ElasticConfig(                      # noqa: E731
                monitor=ShardMonitor(1, StragglerConfig(**MONITOR)),
                remesh_to=fm.drop)
            srv = SolverServer(slots=2, elastic_factory=mk)
            rid = srv.submit(api.SolveRequest(A=mat, b=b, loss="quad",
                                              tol=1e-7, max_iters=400,
                                              device="cpu"))
            wrap = (FaultyLinop, FaultPlan)
        else:
            jlin, mesh = _jsharded(A)
            jfm = jfaults.FaultyMesh(mesh)
            mk = lambda: jel.ElasticConfig(                  # noqa: E731
                monitor=jstraggler.ShardMonitor(
                    1, jstraggler.StragglerConfig(**MONITOR)),
                remesh_to=jfm.drop)
            srv = jserve.SolverServer(slots=2, elastic_factory=mk)
            rid = srv.submit(japi.SolveRequest(
                A=jlin.A, b=b, loss="quad", tol=1e-7, max_iters=400))
            wrap = (jfaults.FaultyLinop, jfaults.FaultPlan)
        srv.step()                                 # group opened
        runner = next(iter(srv._runners.values()))
        runner._eg.linop = wrap[0](runner._eg.linop, wrap[1](
            shard_delays={0: 0.2}, delay_from=8), sleep=_nosleep)
        srv.run()
        out[side] = (srv, srv.result(rid), runner)
    srv, r, runner = out["port"]
    jsrv, jr, _ = out["ref"]
    assert r.info["converged"] and r.info["degraded"] is None
    assert srv.stats["remeshes"] == jsrv.stats["remeshes"] >= 1
    assert runner.priced_remeshes == runner.remeshes >= 1
    assert _maxabs(r.x, ref) < LSTSQ_TOL
    assert _maxabs(r.x, jr.x) < CLEAN_TOL


# -- telemetry: traced requests ----------------------------------------------------

def _lstsq(m=120, n=12, k=1, seed=5):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    return A, [(A @ rng.normal(size=n) + 0.01 * rng.normal(size=m))
               .astype(np.float32) for _ in range(k)]


def test_jsonl_round_trip(tmp_path):
    rec = tel.Recorder()
    with rec.span("phase", k=1):
        pass
    rec.counter("n").inc(2)
    rec.histogram("h").observe(0.01)
    rec.record_plan_actual(
        planner.plan("fused_grad", {"m": 64, "n": 8}, backend="cpu"), 1e-5)
    path = tmp_path / "events.jsonl"
    assert rec.export_jsonl(path) == len(rec.events())
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert {"span", "counter", "histogram", "plan_actual"} \
        <= {e["type"] for e in events}
    span = next(e for e in events if e["type"] == "span")
    assert span["name"] == "phase" and span["attrs"]["k"] == 1
    rec.clear()
    assert rec.events() == [] and rec.plan_actual() == []


def test_traced_solve_has_trace_and_matches_untraced():
    A, (b,) = _lstsq()
    kw = dict(A=A, b=b, loss="quad", tol=1e-7, max_iters=300, device="cpu",
              L0=float(np.linalg.norm(A, 2) ** 2))
    ref = api.solve(api.SolveRequest(**kw))
    res = api.solve(api.SolveRequest(telemetry=True, **kw))
    assert torch.equal(res.x, ref.x)
    trace = res.info["trace"]
    assert trace["spans"] >= 1 and "api.solve" in trace["phases"]
    assert "trace" not in ref.info and tel.current() is tel.NULL
    jres = japi.solve(japi.SolveRequest(telemetry=True, **{
        k: v for k, v in kw.items() if k != "device"}))
    assert set(trace) == set(jres.info["trace"])


def test_traced_elastic_solve_covers_solver_phases(tmp_path):
    """The checkpointing path is the fully instrumented one: iteration,
    pass, seed and checkpoint spans, and plan-vs-actual records of the
    group pass that carry the planner's terms."""
    A, (b,) = _lstsq(m=150, n=10)
    rec = tel.Recorder()
    res = api.solve(api.SolveRequest(
        A=A, b=b, loss="quad", tol=1e-7, max_iters=300, device="cpu",
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=10,
        telemetry=rec))
    assert res.info["converged"]
    phases = set(res.info["trace"]["phases"])
    for name in ("api.solve", "solver.iteration", "solver.fused_pass",
                 "solver.seed_pass", "solver.checkpoint", "solver.validate",
                 "checkpoint.write"):
        assert name in phases, (name, phases)
    pva = res.info["trace"]["plan_vs_actual"]["fused_grad_multi"]
    assert pva["records"] == res.info["iterations"] and pva["ratio"] > 0
    assert all("flops" in r for r in rec.calibration_records())


def test_traced_svd_and_similarities():
    A, _ = _lstsq(m=96, n=12)
    R = RowMatrix.create(A, device="cpu")
    r1 = api.svd(api.SvdRequest(A=R, k=3, telemetry=True, device="cpu"))
    assert "api.svd" in r1.info["trace"]["phases"]
    r2 = api.similarities(api.SimilarityRequest(A=R, telemetry=True,
                                                device="cpu"))
    assert "api.similarities" in r2.info["trace"]["phases"]


def test_span_tree_covers_recovery_phases(tmp_path):
    """A group that hits an injected straggler records a span tree over
    iterate / pass / checkpoint / re-mesh / rebuild, exportable to
    Perfetto, with the trip and the re-mesh as counters."""
    A, bs = _lstsq(m=256, n=16, k=2, seed=9)
    fm = FaultyMesh(T.single_device_mesh("cpu"))
    lin = FaultyLinop(_port(A), FaultPlan(shard_delays={0: 0.2},
                                          delay_from=4), sleep=_nosleep)
    cfg = ElasticConfig(
        monitor=ShardMonitor(lin.row_shards(), StragglerConfig(**MONITOR)),
        remesh_to=fm.drop,
        checkpoint=SolveCheckpoint(tmp_path / "ck", every=5,
                                   async_save=False))
    rec = tel.Recorder()
    with tel.recording(rec):
        grp = ElasticGroup(lin, "quad", slots=2, elastic=cfg)
        for b in bs:
            grp.admit_slot(b, tol=1e-7)
        while grp.busy() and grp.iteration < 200:
            grp.step_iteration()
    assert grp.remeshes >= 1 and fm.casualties == [0]
    names = {s.name for s in rec.spans}
    for phase in ("solver.iteration", "solver.fused_pass",
                  "solver.checkpoint", "solver.remesh", "solver.rejit"):
        assert phase in names, (phase, names)
    assert rec.counter("solver.remeshes").value >= 1
    assert rec.counter("straggler.trips").value >= 1
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name in ("solver.fused_pass", "solver.remesh"):
            assert by_id[s.parent].name == "solver.iteration"
    assert any(e.get("name") == "solver.remesh"
               for e in rec.chrome_trace()["traceEvents"])


def test_solve_elastic_path(tmp_path):
    A, (b,) = _lstsq()
    res = api.solve(api.SolveRequest(
        A=A, b=b, loss="quad", tol=1e-7, max_iters=300, device="cpu",
        checkpoint_dir=str(tmp_path / "ck")))
    for key in ("iterations", "a_passes", "converged", "plan", "degraded",
                "precision"):
        assert key in res.info
    assert res.info["converged"] and res.info["precision"] == "f32"


# -- four gloo ranks ----------------------------------------------------------------

@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """tests/torch_fault_cases.elastic_rank on 4 gloo CPU ranks (one
    spawn, a few seconds), with the reference's clean one-device solve of
    the same problem."""
    import torch_fault_cases as C
    from repro_torch.launch import mesh as lmesh

    A, b, ref = _lstsq_setup()
    d = tmp_path_factory.mktemp("ck2")
    ranks = lmesh.spawn(C.elastic_rank, 4, args=({"A": A, "b": b}, str(d)),
                        backend="gloo", device="cpu", timeout_s=60)
    jx, jinfo = jel.solve_elastic(_ref(A), "quad", b, **C.SOLVE)
    return {"ranks": ranks, "A": A, "b": b, "lstsq": ref, "jx": jx,
            "jinfo": jinfo, "ckpt_dir": d, "cases": C}


@pytest.mark.parametrize("case,dropped", [("straggler", 0), ("loss", 2)])
def test_remesh_on_four_ranks(four_ranks, case, dropped):
    """A straggler trip (shard 0) and a device loss (shard 2) on a (4, 1)
    mesh: every rank re-meshes once onto the three survivors, the
    survivors end with the same bits, within the reference's tolerances
    of its one-device clean solve, and the dropped rank enters no
    collective after the re-mesh and returns its last iterate."""
    ranks = [r[case] for r in four_ranks["ranks"]]
    survivors = [r for i, r in enumerate(ranks) if i != dropped]
    x0 = survivors[0]["x"]
    for r in ranks:
        assert r["casualties"] == [dropped] and r["info"]["remeshes"] == 1
        assert r["delays"] == {}
    for r in survivors:
        assert torch.equal(r["x"], x0)
        assert r["info"]["converged"] and "dropped" not in r["info"]
        assert r["after_remesh"] > 0
    assert _maxabs(x0, four_ranks["jx"]) < CLEAN_TOL
    assert _maxabs(x0, four_ranks["lstsq"]) < LSTSQ_TOL
    lost = ranks[dropped]
    assert lost["info"]["dropped"] and lost["after_remesh"] == 0
    assert not lost["info"]["converged"]
    assert bool(torch.isfinite(lost["x"]).all())


def test_checkpoint_written_on_two_ranks_resumes_on_one(four_ranks):
    """A solve on ranks 0 and 1 checkpoints every 5 iterations (rank 0
    writes) and stops at 20; one device resumes it to 40, as the
    reference's resumed solve does."""
    C = four_ranks["cases"]
    pair = [r["checkpoint"] for r in four_ranks["ranks"][:2]]
    assert all("checkpoint" not in r for r in four_ranks["ranks"][2:])
    assert torch.equal(pair[0]["x"], pair[1]["x"])
    assert [p["info"]["checkpoint_saves"] for p in pair] == [4, 4]
    A, b = four_ranks["A"], four_ranks["b"]
    x, info = solve_elastic(
        _port(A), "quad", b, tol=0.0, max_iters=2 * C.CKPT["cut"],
        resume=True, elastic=ElasticConfig(checkpoint=SolveCheckpoint(
            four_ranks["ckpt_dir"], every=C.CKPT["every"])))
    assert info["resumed_from"] == C.CKPT["cut"]
    assert info["iterations"] == 2 * C.CKPT["cut"]
    jx, _ = jel.solve_elastic(_ref(A), "quad", b, tol=0.0,
                              max_iters=2 * C.CKPT["cut"])
    assert _maxabs(x, jx) < CLEAN_TOL
