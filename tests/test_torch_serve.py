"""The port's serving frontend (launch/serve) on the CPU: the reference's
tests/test_serve.py cases run on the port, one trace served by both
servers, and the telemetry the server reads against the reference's.

Group answers are compared at convergence (trajectories differ in float
summation order between slot widths).  The port counts A-passes at run
time, so a CountingLinop's fused_grad_multi count equals the runner's
``a_passes`` exactly, whatever the group width.
"""
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.launch import serve as jserve
from repro.launch import telemetry as jtel
from repro_torch import api
from repro_torch.core.distmat import RowMatrix
from repro_torch.core.tfocs import CountingLinop, LinopMatrix
from repro_torch.launch import telemetry as tel
from repro_torch.launch.serve import (GroupRunner, SolverServer, batchable,
                                      group_key)


def _trace(m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    bs = [(A @ rng.normal(size=n) + 0.01 * rng.normal(size=m))
          .astype(np.float32) for _ in range(k)]
    return A, bs


def _request(A, b, method="gra", **kw):
    kw.setdefault("tol", 1e-5 if method == "lbfgs" else 1e-7)
    kw.setdefault("max_iters", 400)
    return api.SolveRequest(A=A, b=b, loss="quad", method=method,
                            device="cpu", **kw)


def _lstsq(A, b):
    return np.linalg.lstsq(A, b, rcond=None)[0]


class TestGroupParity:
    @pytest.mark.parametrize("method", ["gra", "acc_rb", "lbfgs"])
    def test_group_matches_sequential(self, method):
        m, n, k = 131, 16, 4                       # ragged
        A, bs = _trace(m, n, k)
        grouped = SolverServer(slots=k)
        ids = [grouped.submit(_request(A, b, method)) for b in bs]
        grouped.run()
        serial = SolverServer(slots=1)
        sids = [serial.submit(_request(A, b, method)) for b in bs]
        serial.run()
        for rid, sid in zip(ids, sids):
            g, s = grouped.result(rid), serial.result(sid)
            assert g.info["plan"] == "fused-group"
            assert float((g.x - s.x).abs().max()) < 1e-4, method

    def test_forty_slot_group_matches_serial_solves(self):
        """One acc_rb group of 40 slots (five 8-slot chunks of the fused
        kernel, past its former 32-slot cap) answers as the same requests
        served one at a time and as api.solve, request by request; its
        A-passes are the group passes while resident."""
        m, n, k = 131, 16, 40
        A, bs = _trace(m, n, k, seed=40)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            grouped, serial = SolverServer(slots=k), SolverServer(slots=1)
            ids = [grouped.submit(_request(A, b, "acc_rb")) for b in bs]
            sids = [serial.submit(_request(A, b, "acc_rb")) for b in bs]
            grouped.run()
            serial.run()
            assert grouped.stats["a_passes"] == max(
                grouped.result(i).info["a_passes"] for i in ids)
            for rid, sid, b in zip(ids, sids, bs):
                g, s = grouped.result(rid), serial.result(sid)
                d = api.solve(_request(A, b, "acc_rb"))
                assert g.info["plan"] == "fused-group"
                assert g.info["converged"] and s.info["converged"]
                assert float((g.x - s.x).abs().max()) < 1e-4
                assert float((g.x - d.x).abs().max()) < 1e-4
        finally:
            torch.set_num_threads(threads)

    def test_group_solutions_correct(self):
        m, n, k = 120, 12, 5
        A, bs = _trace(m, n, k, seed=3)
        srv = SolverServer(slots=k)
        ids = [srv.submit(_request(A, b)) for b in bs]
        srv.run()
        for rid, b in zip(ids, bs):
            r = srv.result(rid)
            assert r.info["converged"]
            assert float(np.max(np.abs(r.x.numpy() - _lstsq(A, b)))) < 1e-3
            for key in ("iterations", "a_passes", "converged", "plan"):
                assert key in r.info

    def test_residents_unaffected_by_slot_churn(self):
        """A resident's trajectory is bit-identical whether its neighbours
        retire and admit around it or not."""
        m, n = 96, 8
        A, bs = _trace(m, n, 3, seed=5)
        quiet = SolverServer(slots=3)
        qid = quiet.submit(_request(A, bs[0], max_iters=60, tol=0.0))
        quiet.run()
        churn = SolverServer(slots=3)
        cid = churn.submit(_request(A, bs[0], max_iters=60, tol=0.0))
        churn.submit(_request(A, bs[1], max_iters=5, tol=0.0))
        for _ in range(10):
            churn.step()
        churn.submit(_request(A, bs[2], max_iters=5, tol=0.0))
        churn.run()
        assert torch.equal(quiet.result(qid).x, churn.result(cid).x)


class TestAPassSharing:
    def _run_group(self, A, bs, width, iters, method="gra"):
        """Serve `bs` in groups of `width` through one CountingLinop-wrapped
        runner; returns (fused_grad_multi calls, runner passes)."""
        lin = CountingLinop(LinopMatrix(torch.from_numpy(A)))
        runner = GroupRunner(lin, "quad", method=method, slots=width)
        for start in range(0, len(bs), width):
            for b in bs[start:start + width]:
                runner.admit(_request(A, b, method, tol=0.0,
                                      max_iters=iters))
            while runner.busy():
                runner.step()
        assert lin.counts["fused_grad_multi"] == runner.a_passes
        assert lin.total() == runner.a_passes
        return lin.counts["fused_grad_multi"], runner.a_passes

    def test_group_passes_equal_single_request_passes(self):
        """A shared-A group of k requests takes exactly as many A-passes as
        one request when the members backtrack alike (same b); with
        distinct right-hand sides the group pays the worst member's
        backtracks, still far below the serial sum."""
        m, n, iters = 97, 12, 8
        A, bs = _trace(m, n, 4, seed=7)
        _, passes_1 = self._run_group(A, bs[:1], 1, iters)
        _, passes_k = self._run_group(A, [bs[0]] * 4, 4, iters)
        assert passes_k == passes_1
        singles = [self._run_group(A, [b], 1, iters)[1] for b in bs]
        _, passes_d = self._run_group(A, bs, 4, iters)
        assert passes_d <= sum(singles) - (len(bs) - 1) * iters
        assert max(singles) <= passes_d
        assert sum(singles) > 2 * passes_d

    def test_acc_group_shares_passes(self):
        m, n, iters = 97, 12, 8
        A, bs = _trace(m, n, 4, seed=21)
        _, passes_1 = self._run_group(A, bs[:1], 1, iters, "acc_rb")
        _, passes_k = self._run_group(A, [bs[0]] * 4, 4, iters, "acc_rb")
        assert passes_k == passes_1
        singles = [self._run_group(A, [b], 1, iters, "acc_rb")[1]
                   for b in bs]
        _, passes_d = self._run_group(A, bs, 4, iters, "acc_rb")
        assert sum(singles) > 2 * passes_d

    def test_counting_linop_sees_no_unfused_calls(self):
        A, bs = _trace(64, 8, 2, seed=9)
        lin = CountingLinop(LinopMatrix(torch.from_numpy(A)))
        runner = GroupRunner(lin, "quad", slots=2)
        for b in bs:
            runner.admit(_request(A, b, tol=0.0, max_iters=3))
        while runner.busy():
            runner.step()
        assert lin.counts["apply"] == lin.counts["adjoint"] == 0
        assert lin.counts["fused_grad"] == 0
        assert lin.counts["fused_grad_multi"] > 0


class TestScheduler:
    def test_co_admission_into_one_group(self):
        """Every request sharing a group's matrix is admitted at once and
        served by the same fused pass."""
        m, n, k = 96, 16, 4
        A, bs = _trace(m, n, k, seed=13)
        srv = SolverServer(slots=k)
        for b in bs:
            srv.submit(_request(A, b))
        srv.step()
        assert srv.pending() == 0 and len(srv._runners) == 1
        srv.run()
        assert len(srv._events) == k

    def test_retirement_frees_slots_mid_solve(self):
        m, n = 120, 12
        A, bs = _trace(m, n, 3, seed=15)
        srv = SolverServer(slots=2)
        ids = [srv.submit(_request(A, b)) for b in bs]
        srv.step()
        assert srv.pending() == 1                  # no slot yet for #3
        runner = next(iter(srv._runners.values()))
        assert runner.free_slots() == 0
        srv.run()
        for rid, b in zip(ids, bs):
            r = srv.result(rid)
            assert float(np.max(np.abs(r.x.numpy() - _lstsq(A, b)))) < 1e-3
        assert [e[0] for e in srv._events][0] != ids[2]

    def test_fifo_fairness_under_overload(self):
        """A full group blocks the head of the queue and everything behind
        it: a later request for another matrix cannot overtake it."""
        m, n = 64, 8
        A1, bs1 = _trace(m, n, 3, seed=20)
        A2, bs2 = _trace(m, n, 1, seed=21)
        srv = SolverServer(slots=2)
        ids = [srv.submit(_request(A1, b)) for b in bs1]
        late = srv.submit(_request(A2, bs2[0]))
        srv.step()
        assert srv.pending() == 2 and len(srv._runners) == 1
        admitted, queued = [], [q.request_id for q in srv._queue]
        while srv.busy():
            srv.step()
            now = [q.request_id for q in srv._queue]
            admitted += [r for r in queued if r not in now]
            queued = now
        assert admitted == [ids[2], late]
        assert all(srv.result(r) is not None for r in ids + [late])

    def test_budget_and_elastic_factory(self):
        # budget_s: the budget cases above and tests/test_torch_planner.py;
        # an elastic_factory is called once a group
        # (tests/test_torch_fault_tolerance.py drives its recovery).
        assert SolverServer(budget_s=1e-3, backend="cpu").budget_s == 1e-3
        made = []
        srv = SolverServer(elastic_factory=lambda: made.append(1))
        A, bs = _trace(32, 4, 2)
        for b in bs:
            srv.submit(_request(A, b))
        srv.run()
        assert made == [1] and srv.stats["remeshes"] == 0

    def test_lbfgs_with_reg_rejected_at_submit(self):
        A, bs = _trace(32, 4, 1)
        srv = SolverServer()
        with pytest.raises(ValueError):
            srv.submit(api.SolveRequest(A=A, b=bs[0], loss="quad",
                                        method="lbfgs", reg="l1", lam=0.1,
                                        device="cpu"))

    def test_mixed_queue_oneshots(self):
        """SVD and similarity requests and non-batchable solves ride the
        same FIFO queue as one-shot jobs and return standardized Results."""
        m, n = 96, 12
        A, bs = _trace(m, n, 1, seed=17)
        R = RowMatrix.create(A, device="cpu")
        srv = SolverServer(slots=2)
        s0 = srv.submit(_request(A, bs[0]))
        s1 = srv.submit(api.SvdRequest(A=R, k=3, device="cpu"))
        y = np.sign(bs[0]).astype(np.float32)
        s3 = srv.submit(api.SolveRequest(A=A, b=y, loss="logistic",
                                         method="acc_rb", max_iters=80,
                                         device="cpu"))
        s2 = srv.submit(api.SimilarityRequest(A=R, device="cpu"))
        res = srv.run()
        assert len(res) == 4
        assert srv.result(s2).factors[0].shape == (n, n)
        assert srv.result(s2).info["plan"] == "gram"
        sv = np.linalg.svd(A, compute_uv=False)[:3]
        np.testing.assert_allclose(srv.result(s1).factors[1].numpy(), sv,
                                   rtol=1e-3, atol=1e-3)
        assert srv.result(s3).info["iterations"] > 0
        assert srv.stats["oneshot"] == 3
        for rid in (s0, s1, s2, s3):
            info = srv.result(rid).info
            for key in ("iterations", "a_passes", "converged", "plan"):
                assert key in info, (rid, key)
        # Each request finished once: one latency per request.
        assert len(srv.latencies()) == 4

    def test_batchable_and_group_key(self):
        A, bs = _trace(32, 4, 2)
        r1, r2 = _request(A, bs[0]), _request(A, bs[1])
        assert batchable(r1) and group_key(r1) == group_key(r2)
        assert not batchable(api.SvdRequest(A=A, k=2))
        assert batchable(_request(A, bs[0], method="acc"))
        assert not batchable(api.SolveRequest(
            A=A, b=np.sign(bs[0]).astype(np.float32), loss="logistic",
            method="acc_rb", device="cpu"))
        r3 = api.SolveRequest(A=A, b=bs[0], loss="huber", param=0.5,
                              device="cpu")
        assert group_key(r3) != group_key(r1)
        assert not batchable(_request(A, bs[0], method="acc_b"))

    def test_l1_group_lambda_per_slot(self):
        m, n = 120, 10
        A, bs = _trace(m, n, 1, seed=19)
        srv = SolverServer(slots=2)
        lo = srv.submit(_request(A, bs[0], reg="l1", lam=1e-4))
        hi = srv.submit(_request(A, bs[0], reg="l1", lam=5.0))
        srv.run()
        assert len(srv._runners) == 1              # one shared group
        x_lo, x_hi = srv.result(lo).x, srv.result(hi).x
        assert float(x_hi.abs().sum()) < float(x_lo.abs().sum())

    def test_overloaded_at_max_pending(self):
        A, bs = _trace(48, 6, 3, seed=23)
        srv = SolverServer(slots=2, max_pending=2)
        ids = [srv.submit(_request(A, b)) for b in bs]
        shed = srv.result(ids[2])
        assert isinstance(shed, api.Overloaded) and shed.x is None
        assert shed.info["degraded"] == "overloaded"
        assert shed.info["plan"] == "rejected"
        assert srv.pending() == 2 and srv.stats["shed"] == 1
        srv.run()
        assert srv.stats["degraded"] == {"overloaded": 1}
        assert all(srv.result(r).info["converged"] for r in ids[:2])

    def test_deadline_retires_with_best_iterate(self):
        """A resident past its wall deadline retires with its best iterate,
        and a queued request whose deadline burnt in the queue is answered
        at once without a pass."""
        A, bs = _trace(80, 8, 3, seed=25)
        srv = SolverServer(slots=1)
        slow = srv.submit(_request(A, bs[0], tol=0.0, max_iters=10_000,
                                   deadline_s=0.05))
        queued = srv.submit(_request(A, bs[1], deadline_s=0.01))
        srv.run()
        r = srv.result(slow)
        assert r.info["degraded"] == "deadline" and not r.info["converged"]
        assert 0 < r.info["iterations"] < 10_000
        assert bool(torch.isfinite(r.x).all())
        q = srv.result(queued)
        assert q.info["plan"] == "expired" and q.info["a_passes"] == 0
        assert srv.stats["expired"] == 1
        assert srv.stats["degraded"]["deadline"] == 2
        # On the direct path gra runs the elastic executor; a one-shot
        # acc_b runs whole and reports an overrun after the fact.
        direct = api.solve(_request(A, bs[2], deadline_s=60.0))
        assert direct.info["plan"] == "elastic"
        assert direct.info["degraded"] is None
        rid = srv.submit(api.SolveRequest(A=A, b=bs[2], method="acc_b",
                                          deadline_s=60.0, device="cpu"))
        srv.run()
        assert srv.result(rid).info["degraded"] != "deadline"
        assert srv.stats["oneshot"] == 1


def test_one_trace_served_by_both_servers():
    """The same trace through the reference's server and the port's: every
    request gets the same x (1e-4) and the same A-passes.  Methods without
    marginal backtracking decisions (acc has none; gra stops at tol 1e-4)
    keep the pass counts exactly equal."""
    m, n = 131, 16
    A, bs = _trace(m, n, 6, seed=27)
    plan = [("gra", dict(tol=1e-4)), ("gra", dict(tol=1e-4, reg="l1",
                                                  lam=0.5)),
            ("acc", dict(tol=1e-6)), ("acc", dict(tol=1e-6)),
            ("gra", dict(tol=1e-4)), ("acc", dict(tol=1e-6))]
    L0 = float(np.linalg.norm(A, 2) ** 2)
    jsrv, tsrv = jserve.SolverServer(slots=2), SolverServer(slots=2)
    jids, tids = [], []
    for (method, kw), b in zip(plan, bs):
        kw = dict(kw, method=method, loss="quad", L0=L0, max_iters=300)
        jids.append(jsrv.submit(japi.SolveRequest(A=A, b=b, **kw)))
        tids.append(tsrv.submit(api.SolveRequest(A=A, b=b, device="cpu",
                                                 **kw)))
    jsrv.run()
    tsrv.run()
    for jid, tid in zip(jids, tids):
        j, t = jsrv.result(jid), tsrv.result(tid)
        assert t.info["a_passes"] == j.info["a_passes"], (tid, t.info)
        assert t.info["iterations"] == j.info["iterations"]
        assert float(np.max(np.abs(t.x.numpy() - np.asarray(j.x)))) < 1e-4
    assert tsrv.stats["a_passes"] == jsrv.stats["a_passes"]
    assert tsrv.stats["steps"] == jsrv.stats["steps"]


# -- telemetry ----------------------------------------------------------------

OBS = [3e-7, 1e-6, 2.5e-5, 4e-4, 4e-4, 0.013, 0.2, 1.7, 30.0, 5000.0]


def test_histogram_percentiles_match_reference():
    h, jh = tel.Recorder().histogram("x"), jtel.Recorder().histogram("x")
    for v in OBS:
        h.observe(v)
        jh.observe(v)
    assert h.counts == jh.counts
    assert h.snapshot() == jh.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert h.percentile(q) == jh.percentile(q)
    assert tel.HIST_BOUNDS == jtel.HIST_BOUNDS


def test_counters_and_snapshot_match_reference():
    rec, jrec = tel.Recorder(), jtel.Recorder()
    for r in (rec, jrec):
        r.counter("serve.steps").inc(3)
        r.counter("serve.steps").inc()
        r.counter("serve.degraded", reason="deadline").inc()
        r.counter("serve.degraded", reason="overloaded").inc(2)
        r.gauge("g").set(1.5)
        r.histogram("lat").observe(0.25)
    assert rec.counters("serve.degraded") == jrec.counters("serve.degraded")
    snap, jsnap = rec.snapshot(), jrec.snapshot()
    jsnap.pop("plan_actual_records")
    assert snap == jsnap


def test_spans_nest_and_export(tmp_path):
    rec = tel.Recorder()
    x = torch.ones(3)
    with rec.span("outer", a=1) as outer:
        with rec.span("inner") as inner:
            inner.sync_on((x, {"y": x}))         # CPU tensors: no sync
            inner.annotate(tries=2)
    spans = {s.name: s for s in rec.spans}
    assert spans["inner"].parent == spans["outer"].id
    assert spans["inner"].attrs == {"tries": 2} and outer.dur_s >= 0.0
    summary = rec.summary()
    assert summary["spans"] == 2 and summary["phases"]["outer"]["count"] == 1
    assert [e["type"] for e in rec.events()] == ["span", "span"]
    path = tmp_path / "trace.json"
    assert rec.export_chrome_trace(path) == 4
    assert tel.Recorder(spans=False).span("s") is tel.NULL.span("t")


def test_module_recorder_switches():
    assert not tel.current().enabled
    rec = tel.enable()
    assert tel.current() is rec
    tel.disable()
    assert tel.current() is tel.NULL
    with tel.recording() as scoped:
        srv = SolverServer(slots=1)
        A, bs = _trace(40, 4, 1, seed=29)
        srv.submit(_request(A, bs[0], max_iters=5, tol=0.0))
        srv.run()
    assert tel.current() is tel.NULL
    names = {s.name for s in scoped.spans}
    assert {"serve.admit", "solver.iteration", "solver.seed_pass",
            "solver.fused_pass", "serve.retire"} <= names
    assert scoped.counter("serve.admitted").value == 1
    assert tel.NULL.counter("c").inc() == 0


class _PlainOperator:
    """A linear operator with no matrix behind an ``.A``: only apply and
    adjoint, as a user's own operator may be."""

    def __init__(self, a: torch.Tensor):
        self.a = a

    @property
    def in_shape(self):
        return (self.a.shape[1],)

    @property
    def out_shape(self):
        return (self.a.shape[0],)

    @property
    def device(self):
        return self.a.device

    def apply(self, x):
        return self.a @ x

    def adjoint(self, y):
        return self.a.T @ y


def test_problem_over_a_plain_operator_is_served():
    """A problem whose operator has no ``.A`` is admitted (only a
    row-sharded matrix is refused) and served as api.solve answers it."""
    import dataclasses

    from repro_torch.core.optim.problems import make_problem
    p = make_problem("linear", m=64, n=16, device="cpu")
    plain = dataclasses.replace(p, linop=_PlainOperator(p.linop.A.rows))

    def request():
        return api.SolveRequest(problem=plain, method="gra", max_iters=50,
                                tol=1e-6, device="cpu")

    srv = SolverServer(slots=1)
    rid = srv.submit(request())
    srv.run()
    got, want = srv.result(rid), api.solve(request())
    assert torch.equal(got.x, want.x)
    assert got.info["iterations"] == want.info["iterations"]
