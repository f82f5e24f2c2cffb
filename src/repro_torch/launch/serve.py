"""Solver serving frontend: concurrent matrix jobs, one A-pass per group.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 --m 512 \
        --n 64 [--device cpu]

Counterpart of src/repro/launch/serve.py.  When several clients solve
against the SAME design matrix A (multi-user regression, per-target least
squares, one-vs-rest logistic), their iterations share each pass over A:

  * ``SolverServer.submit`` enqueues the ``repro_torch.api`` request
    objects, the same dataclasses the direct call path uses;
  * solve requests sharing (A, loss, param, reg, engine) form a GROUP
    served by one ``GroupRunner``: per-request solver state is batched over
    the request axis and every solver iteration is ONE fused multi-RHS
    A-pass (the fused_grad_multi kernel via core/optim/batched), so a group
    of k requests costs the passes per iteration of one;
  * continuous batching: a fixed number of slots per group, requests
    admitted and retired BETWEEN solver iterations by editing slot rows,
    inactive slots frozen by the engines' per-slot masks;
  * planner-priced admission: ``budget_s`` bounds the modeled device
    seconds a scheduler step may spend (launch/planner.plan: a group's
    fused pass a step, a one-shot's whole job).  Joining an active group
    is free; opening one or running a one-shot consumes budget; when
    nothing spends budget the head is always admitted;
  * the queue is strictly FIFO: a request that cannot be admitted (its
    group is full, or the budget is spent) blocks those behind it, so
    overload degrades in arrival order.

SVD and similarity requests and non-batchable solves (escape-hatch
problems, smooths or proxes, non-quadratic accelerated requests) run as
one-shot jobs through the same FIFO queue, via the same ``repro_torch.api``
executors; an SVD wide enough for the randomized mode runs it
(core/linalg/randsvd, the randsketch kernel), and a similarity request runs DIMSUM on the matrix's
Gram (tsgram dense, bsr_rmatmul sparse).  A group's matrix may be a
RowMatrix, a SparseRowMatrix or a plain tensor: its group pass is
fused_grad_multi, or fused_grad_bsr_multi on the stored blocks.

The frontend is hardened as the reference's is:

  * every GroupRunner drives core/optim/elastic.ElasticGroup, so a server
    built with an ``elastic_factory`` gets straggler detection, mid-solve
    re-meshing and bounded retry with backoff per group, and the group is
    priced again on its new shard shape after a re-mesh (``remeshes`` in
    ``stats``); when recovery is exhausted the residents are retired with
    their best iterates and ``degraded="fault"``;
  * a grouped request's ``deadline_s`` retires it with its best iterate
    once the deadline passes; a one-shot's is honoured by ``api`` (the
    elastic path for gra/lbfgs, post hoc otherwise), and a request whose
    deadline passed while it waited in the queue is answered at once
    without running; checkpointed solves run one-shot, through the
    resumable path;
  * ``max_pending`` sheds load at submit with a typed ``api.Overloaded``
    result.

On a mesh (a RowMatrix or SparseRowMatrix sharded over row ranks) every
rank builds the server and submits the same requests in the same order,
as the cluster solves are called; each group runs its pass on the rank's
strips and all_reduces (f, g), so every answer has the same bits on every
rank.  Every decision that reads a clock or a price (a queued or resident
request's deadline, the budget's admission) is taken by the mesh's first
rank and sent to the others once a step; that rank alone writes the
telemetry (``export_telemetry``).

Every answer is an ``api.Result``; for served solves ``info["a_passes"]``
is the number of GROUP passes taken while the request was resident.  The
server's counters are always live (``stats``), with ``serve.queue_wait_s``
and ``serve.latency_s`` histograms; scheduler spans are recorded when the
server is built under ``telemetry.enable()`` or given a recorder.

``main`` is the demo CLI: a RowMatrix of the reference's numpy draws on
``--device`` (the card unless asked for the CPU), ``--requests`` quad/gra
requests against it, and the served count, group A-passes and latencies.
"""
from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.distmat.rowmatrix import RowMatrix
from repro_torch.core.optim import elastic as _elastic
from repro_torch.core.distmat.sparserow import SparseRowMatrix
from repro_torch.launch import planner as _planner
from repro_torch.launch import telemetry as _tel

# Engines the group runner batches; everything else is served one-shot.
GROUP_METHODS = _elastic.GROUP_METHODS

# The server's aggregate counters (rendered by SolverServer.stats).
_STAT_KEYS = ("steps", "a_passes", "admitted", "oneshot", "deferred_steps",
              "shed", "expired", "remeshes")


def group_key(req: api.SolveRequest):
    """Requests with equal keys can share fused A-passes: same matrix
    object on the same device, same row-separable loss, same loss scalar,
    same reg KIND (per-slot lam rides in the batched prox), same engine."""
    return (id(req.A), str(req.device), req.loss, float(req.param), req.reg,
            req.method)


def batchable(req: Any) -> bool:
    """Solve requests in the (A, b) form whose engine has a batched group;
    accelerated groups exist for quadratic losses only."""
    return (isinstance(req, api.SolveRequest) and req.problem is None
            and req.smooth is None and req.prox is None
            and req.method in GROUP_METHODS
            and (req.loss == "quad"
                 or req.method not in _elastic.ACC_METHODS)
            and req.checkpoint_dir is None)


class GroupRunner:
    """Continuous-batching executor for one request group.

    Owns `slots` lanes of batched solver state (core/optim/elastic over
    core/optim/batched) on a shared linop; `admit` writes a request into a
    free lane, `step` runs one solver iteration for every active lane in
    ONE fused group A-pass (plus shared backtracking attempts) and returns
    the lanes that finished as `api.Result`s.  The engines freeze inactive
    lanes bit for bit, so residents never see their neighbours churn."""

    def __init__(self, linop, kind: str, param: float = 1.0, *,
                 reg: str = "none", method: str = "gra", slots: int = 8,
                 mem: int = 10,
                 elastic: _elastic.ElasticConfig | None = None,
                 telemetry: _tel.Recorder | None = None):
        # All solver state lives in the elastic executor; the runner adds
        # the serving concerns on top (request metadata, deadlines,
        # retirement into api.Results, the planner price).
        self.tel = telemetry if telemetry is not None else _tel.NULL
        self._eg = _elastic.ElasticGroup(linop, kind, param, reg=reg,
                                         method=method, slots=slots,
                                         mem=mem, elastic=elastic,
                                         telemetry=telemetry)
        self.kind, self.param = kind, param
        self.reg, self.method, self.slots = reg, method, slots
        self.meta: list[dict | None] = [None] * slots
        # Modeled device seconds of one group pass (the server's budget
        # pricing sets it when it opens the group, and again after a
        # re-mesh changes the shard shape).
        self.price_s = 0.0
        self.priced_remeshes = 0

    # -- delegated solver state (the executor owns it) ------------------------

    @property
    def linop(self):
        return self._eg.linop

    @property
    def state(self):
        return self._eg.state

    @property
    def active(self):
        return self._eg.active

    @property
    def a_passes(self) -> int:
        return self._eg.a_passes

    @property
    def remeshes(self) -> int:
        return self._eg.remeshes

    def free_slots(self) -> int:
        return self._eg.free_slots()

    def busy(self) -> bool:
        return self._eg.busy()

    def admit(self, req: api.SolveRequest) -> int:
        """Write `req` into a free slot; costs no pass by itself (the next
        step's seed recomputes F/G for the whole group in one)."""
        i = self._eg.admit_slot(req.b, lam=float(req.lam),
                                tol=float(req.tol), x0=req.x0,
                                L0=float(req.L0))
        self.meta[i] = {"req": req, "admit_passes": self.a_passes,
                        "deadline_at": (time.monotonic() + req.deadline_s
                                        if req.deadline_s else None)}
        return i

    # -- the iteration --------------------------------------------------------

    def step(self, expired=None) -> list[api.Result]:
        """One solver iteration for every active slot; returns retired
        lanes.  `expired` lists the slots whose deadline passed, as the
        server decided them this step (on a mesh, the first rank's
        clock); None reads this process's clock."""
        if not self.busy():
            return []
        out = self._expire_deadlines(
            self.deadlines_passed() if expired is None else expired)
        if not self.busy():
            return out
        try:
            self._eg.step_iteration()
        except (_elastic.TransientShardError,
                _elastic.DeviceLostError) as e:
            # Recovery exhausted (or no re-mesh policy): the residents get
            # their best iterates back, and the serving loop goes on.
            with self.tel.span("serve.recover", error=str(e)):
                for i in range(self.slots):
                    if self.active[i]:
                        out.append(self._retire(i, False, degraded="fault",
                                                error=str(e)))
            return out
        done = self.state.done.cpu().numpy()
        k = self.state.k.cpu().numpy()
        for i in range(self.slots):
            if self.active[i] and (
                    done[i] or k[i] >= self.meta[i]["req"].max_iters):
                out.append(self._retire(i, bool(done[i])))
        return out

    def deadlines_passed(self) -> list[int]:
        """The active slots whose wall deadline has passed, by this
        process's clock."""
        if not any(m is not None and m["deadline_at"] is not None
                   for m in self.meta):
            return []
        now = time.monotonic()
        return [i for i, m in enumerate(self.meta)
                if self.active[i] and m is not None
                and m["deadline_at"] is not None and now > m["deadline_at"]]

    def _expire_deadlines(self, slots) -> list[api.Result]:
        """Retire the residents in `slots` (their wall deadline passed)
        with their best iterates (converged=False, degraded="deadline"),
        so one slow request cannot hold its slot past its budget."""
        return [self._retire(i, False, degraded="deadline") for i in slots
                if self.active[i]]

    def _retire(self, i: int, converged: bool, *,
                degraded: str | None = None,
                error: str | None = None) -> api.Result:
        meta = self.meta[i]
        req = meta["req"]
        if degraded is None and not converged:
            degraded = "max_iterations"
        with self.tel.span("serve.retire", slot=i, converged=converged,
                           degraded=degraded, request_id=req.request_id):
            info = {"iterations": int(self.state.k[i]),
                    # Group passes taken while resident: the amortized cost
                    # (each pass also served every co-resident request).
                    "a_passes": self.a_passes - meta["admit_passes"],
                    "converged": converged, "plan": "fused-group",
                    "objective": float(self.state.obj[i]),
                    "slot": i, "degraded": degraded}
            if error is not None:
                info["error"] = error
            # A copy: the slot's state rows are rewritten in place on the
            # next admit.
            x = self.state.X[i].clone()
            self._eg.clear_slot(i)
            self.meta[i] = None
            return api.Result(x=x, info=info, request_id=req.request_id)


class SolverServer:
    """FIFO request queue + planner-priced admission + continuous batching.

    ``submit`` enqueues a repro_torch.api request; ``step`` admits what the
    slots and the per-step device-time budget allow, runs one solver
    iteration per active group, and returns the requests that finished.
    ``run`` drives steps until the queue and all groups drain.  `backend`
    ("cuda" or "cpu") names the machine model the budget is priced on
    (the card's where there is one)."""

    def __init__(self, *, slots: int = 8, budget_s: float | None = None,
                 backend: str | None = None,
                 max_pending: int | None = None, elastic_factory=None,
                 telemetry: _tel.Recorder | None = None):
        self.budget_s = budget_s
        self.backend = backend
        # () -> core.optim.elastic.ElasticConfig, called once a group so
        # each runner gets its own monitor and checkpoint.
        self.elastic_factory = elastic_factory
        self.slots = slots
        # Load-shedding bound: submits past this queue depth are refused
        # with a typed api.Overloaded result.
        self.max_pending = max_pending
        # Metrics are always on (a private spanless recorder renders the
        # `stats` view); spans ride along when the server is built under
        # telemetry.enable() or given an explicit recorder.
        if telemetry is not None:
            self.tel = telemetry
        else:
            cur = _tel.current()
            self.tel = cur if cur.enabled else _tel.Recorder(spans=False)
        self._c = {k: self.tel.counter("serve." + k) for k in _STAT_KEYS}
        self._h_wait = self.tel.histogram("serve.queue_wait_s")
        self._h_latency = self.tel.histogram("serve.latency_s")
        self._queue: list[Any] = []
        self._runners: dict[Any, GroupRunner] = {}
        self._results: dict[str, api.Result] = {}
        self._submit_t: dict[str, float] = {}
        self._events: list[tuple[str, float, float]] = []
        # The mesh of the sharded matrices served (None: one process).
        # Its first rank takes every decision that reads a clock or a
        # price and sends it to the others once a step.
        self._mesh = None

    @property
    def stats(self) -> dict:
        """Aggregate server statistics from the typed counters, plus the
        per-reason ``degraded`` breakdown."""
        s = {k: c.value for k, c in self._c.items()}
        s["degraded"] = {
            lbl.split("=", 1)[1]: v
            for lbl, v in self.tel.counters("serve.degraded").items()
            if "=" in lbl}
        return s

    # -- queue ----------------------------------------------------------------

    def submit(self, req) -> str:
        """Enqueue `req`.  On a mesh every rank submits the same requests
        in the same order (each b global, or the rank's strip of it)."""
        problem = getattr(req, "problem", None)
        A = getattr(req, "A", None) if problem is None \
            else getattr(getattr(problem, "linop", None), "A", None)
        mesh = getattr(A, "mesh", None)
        if mesh is not None and mesh.size > 1:
            if self._mesh is not None and mesh is not self._mesh:
                raise ValueError("one server serves the matrices of one "
                                 "mesh")
            self._mesh = mesh
        if isinstance(req, api.SolveRequest):
            if req.problem is None and req.smooth is None \
                    and req.method == "lbfgs" and req.reg != "none":
                raise ValueError("method='lbfgs' needs reg='none'")
        if self.max_pending is not None \
                and len(self._queue) >= self.max_pending:
            with self.tel.span("serve.shed", request_id=req.request_id,
                               pending=len(self._queue)):
                self._submit_t[req.request_id] = time.perf_counter()
                self._finish(api.Overloaded(request_id=req.request_id))
                self._c["shed"].inc()
            return req.request_id
        self._queue.append(req)
        self._submit_t[req.request_id] = time.perf_counter()
        return req.request_id

    def pending(self) -> int:
        return len(self._queue)

    def result(self, request_id: str) -> api.Result | None:
        return self._results.get(request_id)

    def latencies(self) -> list[float]:
        """Per-request submit→finish wall seconds, in completion order."""
        return [t1 - t0 for _, t0, t1 in self._events]

    # -- planner pricing ------------------------------------------------------

    def _price(self, req) -> float:
        """Modeled device seconds: a step's for a group (one fused pass,
        however many requests share it), the whole job's for a one-shot."""
        if isinstance(req, api.SolveRequest):
            if req.problem is None:
                return self._price_pass(req.A)
            lin = req.problem.linop
            return _planner.plan(
                "fused_grad", {"m": int(lin.out_shape[0]),
                               "n": int(lin.in_shape[0])},
                backend=self.backend).cost_s
        m, n = req.A.shape
        # A similarity request's Gram pass is the whole job: priced as the
        # Gram-mode SVD of the same matrix.
        k = int(req.k) if isinstance(req, api.SvdRequest) else 1
        return _planner.plan("svd", {"m": int(m), "n": int(n), "k": k},
                             backend=self.backend).cost_s

    def _price_pass(self, A) -> float:
        """Modeled device seconds of one fused pass over the matrix `A`."""
        if isinstance(A, SparseRowMatrix):
            return _planner.plan(
                "fused_grad_bsr", {"m": A.m_pad, "n": A.n_pad, "bs": A.bs,
                                   "ell": A.ell},
                A.data.dtype, backend=self.backend).cost_s
        m, n = A.shape
        return _planner.plan("fused_grad", {"m": int(m), "n": int(n)},
                             backend=self.backend).cost_s

    def _active_cost(self) -> float:
        return sum(r.price_s for r in self._runners.values() if r.busy())

    def _over_budget(self, spent: float, cost: float) -> bool:
        return (self.budget_s is not None and spent > 0
                and spent + cost > self.budget_s)

    # -- scheduling -----------------------------------------------------------

    def _decide(self) -> tuple[list[bool], dict]:
        """This step's decisions that read a clock or a price, taken
        before any is acted on: (for the head of the queue, one flag an
        item, True to admit it and False to answer it expired, up to the
        first that must wait; for each busy group, the slots whose
        deadline passed).  FIFO admission under the device-time budget: a
        request joins its group's runner while it has a free slot (free of
        budget), or opens the group (its price); a full group or a spent
        budget blocks the head of the queue and everything behind it
        (strict arrival-order degradation).  When nothing spends budget
        the head is always admitted, so a budget under one group's pass
        cannot deadlock the queue."""
        expire = {key: r.deadlines_passed()
                  for key, r in self._runners.items() if r.busy()}
        actions: list[bool] = []
        spent = self._active_cost()
        free: dict = {}                    # group key → slots left
        for req in self._queue:
            if self._deadline_burnt(req):
                actions.append(False)
                continue
            if batchable(req):
                key = group_key(req)
                runner = self._runners.get(key)
                if key not in free and runner is not None and runner.busy():
                    free[key] = runner.free_slots()
                if key in free:
                    if free[key] == 0:
                        break                      # group full → wait
                    free[key] -= 1                 # marginal cost: zero
                else:
                    cost = self._price(req)
                    if self._over_budget(spent, cost):
                        break                      # no budget → wait
                    spent += cost
                    free[key] = self.slots - 1
            else:
                cost = self._price(req)
                if self._over_budget(spent, cost):
                    break
                spent += cost
            actions.append(True)
        return actions, expire

    def _decisions(self) -> tuple[list[bool], dict]:
        """``_decide``'s decisions.  On a mesh the first rank alone takes
        them and every rank receives them in one all_reduce of a small
        int32 message (the count of queue actions, the actions, then a
        flag for each slot of each busy group), zero on every other rank:
        a rank that retired a slot another kept would deadlock the next
        group pass's all_reduce."""
        mesh = self._mesh
        if mesh is None:
            return self._decide()
        from repro_torch import compat
        axes = mesh.axis_names
        busy = [key for key, r in self._runners.items() if r.busy()]
        q = len(self._queue)
        msg = [0] * (1 + q + self.slots * len(busy))
        if compat.axis_index(mesh, axes) == 0:
            actions, expire = self._decide()
            msg[0] = len(actions)
            msg[1:1 + len(actions)] = [int(a) for a in actions]
            for g, key in enumerate(busy):
                for i in expire[key]:
                    msg[1 + q + g * self.slots + i] = 1
        msg = compat.psum(torch.tensor(msg, dtype=torch.int32,
                                       device=mesh.device), mesh,
                          axes).tolist()
        flags = msg[1 + q:]
        return ([bool(a) for a in msg[1:1 + msg[0]]],
                {key: [i for i in range(self.slots)
                       if flags[g * self.slots + i]]
                 for g, key in enumerate(busy)})

    def _admit(self, actions: list[bool]) -> list[api.Result]:
        """Act on `actions` (``_decisions``, the same on every rank) for
        the head of the queue: expired answers at once, admissions into
        their group (joined, or opened at its price) and one-shot jobs
        run whole.  Returns the results of the expired and one-shot
        requests."""
        done = []
        for admit in actions:
            req = self._queue.pop(0)
            if not admit:
                res = self._expired(req)
                self._finish(res)
                done.append(res)
                continue
            self._observe_wait(req)
            if batchable(req):
                key = group_key(req)
                runner = self._runners.get(key)
                if runner is not None and runner.busy():
                    with self.tel.span("serve.admit", mode="join",
                                       request_id=req.request_id):
                        runner.admit(req)
                else:
                    with self.tel.span("serve.admit", mode="open",
                                       request_id=req.request_id):
                        if runner is None:
                            runner = GroupRunner(
                                api.solve_linop(req), req.loss, req.param,
                                reg=req.reg, method=req.method,
                                slots=self.slots,
                                elastic=(self.elastic_factory()
                                         if self.elastic_factory else None),
                                telemetry=self.tel)
                            self._runners[key] = runner
                        runner.price_s = self._price(req)
                        runner.admit(req)
                self._c["admitted"].inc()
            else:
                with self.tel.span("serve.oneshot",
                                   request_id=req.request_id):
                    res = self._run_oneshot(req)
                self._finish(res)
                done.append(res)
                self._c["oneshot"].inc()
        return done

    def _observe_wait(self, req) -> None:
        """Queue-wait histogram: submit→dequeue, observed at admission."""
        t0 = self._submit_t.get(req.request_id)
        if t0 is not None:
            self._h_wait.observe(time.perf_counter() - t0)

    def _deadline_burnt(self, req) -> bool:
        """Dequeue-time deadline check: whether `req`'s wall budget was
        burnt WAITING in the queue (this process's clock)."""
        deadline = getattr(req, "deadline_s", None)
        if deadline is None:
            return False
        t0 = self._submit_t.get(req.request_id)
        return t0 is not None and time.perf_counter() - t0 > deadline

    def _expired(self, req) -> api.Result:
        """The answer to a request whose deadline burnt in the queue:
        degraded at once instead of spending device time on an answer its
        client has abandoned."""
        self._c["expired"].inc()
        return api.Result(
            x=None, info={"iterations": 0, "a_passes": 0,
                          "converged": False, "plan": "expired",
                          "degraded": "deadline"},
            request_id=req.request_id)

    def _run_oneshot(self, req) -> api.Result:
        if isinstance(req, api.SolveRequest):
            return api.solve(req)
        if isinstance(req, api.SvdRequest):
            return api.svd(req)
        return api.similarities(req)

    def _finish(self, res: api.Result) -> None:
        self._results[res.request_id] = res
        t0 = self._submit_t.get(res.request_id, time.perf_counter())
        t1 = time.perf_counter()
        self._events.append((res.request_id, t0, t1))
        self._h_latency.observe(t1 - t0)
        reason = res.info.get("degraded") \
            if isinstance(res.info, dict) else None
        if reason:
            # Per-reason accounting: "overloaded" (shed), "deadline" and
            # "max_iterations" each count apart.
            self.tel.counter("serve.degraded", reason=reason).inc()

    # -- the serving loop -----------------------------------------------------

    def step(self) -> list[api.Result]:
        """One scheduler tick: admit, then one solver iteration per active
        group; returns the requests that completed this tick."""
        self._c["steps"].inc()
        actions, expire = self._decisions()
        out = self._admit(actions)         # one-shots, already finished
        if self._queue:
            self._c["deferred_steps"].inc()
        for key, runner in self._runners.items():
            if runner.busy():
                before = runner.a_passes
                retired = runner.step(expired=expire.get(key, ()))
                self._c["a_passes"].inc(runner.a_passes - before)
                if runner.remeshes != runner.priced_remeshes:
                    # A mid-solve re-mesh changed the shard shape: re-price
                    # the group so the budget sees its new cost.
                    self._c["remeshes"].inc(runner.remeshes
                                            - runner.priced_remeshes)
                    runner.priced_remeshes = runner.remeshes
                    runner.price_s = self._price_pass(
                        _elastic._operand(runner.linop))
                for res in retired:
                    self._finish(res)
                out.extend(retired)
        return out

    def busy(self) -> bool:
        return bool(self._queue) or any(r.busy()
                                        for r in self._runners.values())

    def export_telemetry(self, path) -> int:
        """Write the server's recorder, one JSON event a line, from the
        mesh's first rank alone; returns the events written (0 on the
        other ranks)."""
        mesh = self._mesh
        if mesh is not None and mesh.index(mesh.axis_names) != 0:
            return 0
        return self.tel.export_jsonl(path)

    def run(self, max_steps: int = 100_000) -> list[api.Result]:
        out = []
        while self.busy() and self._c["steps"].value < max_steps:
            out.extend(self.step())
        return out


# -- demo CLI -----------------------------------------------------------------

def main(argv: list[str] | None = None) -> SolverServer:
    """Serve `--requests` quad/gra requests on one m × n matrix and print
    the served count and rate, the group A-passes and the latencies, then
    the first three requests' counts; returns the drained server.  A and
    each request's x are the reference's numpy draws (seed 0); A goes to
    the device once and each b = A x is made there."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--budget-us", type=float, default=None,
                    help="per-step device-time budget (modeled µs)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    A = RowMatrix.create(rng.normal(size=(args.m, args.n)).astype(np.float32),
                         device=args.device)
    server = SolverServer(
        slots=args.slots,
        budget_s=args.budget_us * 1e-6 if args.budget_us else None,
        backend=A.device.type)
    t0 = time.perf_counter()
    ids = []
    for _ in range(args.requests):
        x = torch.from_numpy(rng.normal(size=args.n)).to(A.device).float()
        ids.append(server.submit(api.SolveRequest(
            A=A, b=A.matvec(x), loss="quad", method="gra", tol=1e-6,
            max_iters=200, device=A.device)))
    results = server.run()
    wall = time.perf_counter() - t0
    lats = sorted(server.latencies())
    print(f"served {len(results)} requests in {wall:.3f}s "
          f"({len(results) / wall:.1f} req/s)")
    print(f"group A-passes: {server.stats['a_passes']} "
          f"(scheduler steps: {server.stats['steps']})")
    print(f"latency p50 {lats[len(lats) // 2] * 1e3:.1f}ms  "
          f"p99 {lats[int(len(lats) * 0.99)] * 1e3:.1f}ms")
    for rid in ids[:3]:
        info = server.result(rid).info
        print(f"  {rid}: iters={info['iterations']} "
              f"a_passes={info['a_passes']} converged={info['converged']}")
    return server


if __name__ == "__main__":
    main()
