"""Rank bodies for the dist tests (``test_torch_dist.py``,
``test_torch_obs.py``) and the helper that spawns them.

Not a test module: spawned ranks import it, so it imports torch and the
port only (no JAX).  Ranks meet through ``init_method=file://`` under the
test's ``tmp_path`` (never a TCP port: the suite runs several workers at
once), on gloo, on the CPU.  :func:`run_ranks` joins every rank with a
deadline and fails, never hangs, when a rank dies or overruns.
"""
import os
import queue as queue_lib
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

ENGINES = ("gibbs", "mgpmh", "min-gibbs", "doublemin")


def _rank_main(rank, world, store, fn, args, out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            out.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:                  # reported to the parent, which
        out.put((rank, False, traceback.format_exc()))   # fails the test
        raise


def run_ranks(fn, world, tmp_path, *args, timeout=240.0):
    """``fn(rank, world, *args)`` on ``world`` spawned gloo ranks; returns
    their results in rank order.  Raises AssertionError with the failing
    rank's traceback, or when a rank dies or the deadline passes (the
    survivors are killed)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store-{fn.__name__}-{world}")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, fn, args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=0.5)
            except queue_lib.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                assert not dead, f"a rank died (exit codes {dead})"
                assert time.monotonic() < deadline, (
                    f"ranks overran {timeout} s; {sorted(results)} done")
                continue
            assert ok, f"rank {rank} failed:\n{value}"
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


# -- shared pieces ---------------------------------------------------------

def _mesh(shape):
    from repro_torch.launch.mesh import make_auto_mesh
    return make_auto_mesh(shape, ("data", "model"), device_type="cpu")


def exact_potts_marginals():
    """potts 2x2 D=3 (beta 0.8) and its exact marginals by enumeration."""
    g, exact, _ = exact_potts()
    return g, exact


def exact_potts():
    """potts 2x2 D=3 (beta 0.8), its exact marginals (n, D) and its exact
    edge agreements P(x_a == x_b), one per factor {a, b} in
    :func:`edges` order, by enumeration.  Every marginal is 1/D by colour
    symmetry; the agreements depend on W (a sampler that ignores the
    couplings gives 1/D there too)."""
    from repro_torch.core.factor_graph import (TabularPairwiseGraph,
                                               make_potts_graph)
    g = make_potts_graph(grid=2, beta=0.8, D=3, device="cpu")
    tg = TabularPairwiseGraph.from_match_graph(g)
    a, b = edges(g)
    exact = np.zeros((g.n, g.D))
    agree = np.zeros(len(a))
    for p, s in zip(tg.pi(), tg.all_states()):
        exact[np.arange(g.n), s] += p
        agree += p * (s[a.numpy()] == s[b.numpy()])
    return g, exact, agree


def edges(g):
    """The factors {a, b} (a < b, W_ab > 0) of ``g`` as two index
    tensors."""
    a, b = torch.nonzero(torch.triu(g.W.cpu(), 1) > 0, as_tuple=True)
    return a, b


def agreement(agree, mesh, samples):
    """The mesh-wide fraction of ``samples`` chain snapshots with x_a ==
    x_b, from each rank's summed counts ``agree`` (the model shards of a
    data shard hold the same chains: only model shard 0 contributes).  One
    all-reduce, outside the counted collectives."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import mesh_coords, mesh_group
    if mesh_coords(mesh)[2] != 0:
        agree = torch.zeros_like(agree)
    dist.all_reduce(agree, group=mesh_group(mesh))
    return (agree / samples).numpy()


def _bits(state):
    """Every tensor of a (dist) state, as numpy copies."""
    inner = getattr(state, "inner", state)
    out = {k: getattr(inner, k).clone().numpy()
           for k in ("x", "cache", "accepts", "marg")}
    for k in ("cdf", "flips", "hits"):
        if hasattr(state, k):
            out[k] = getattr(state, k).clone().numpy()
    return out


# -- rank bodies -------------------------------------------------------------

def marginals_rank(rank, world, shape, C=64, S=4, calls=800):
    """The four engines on ``shape`` (data, model) to exact marginals on
    potts 2x2 D=3, as ``tests/test_distributed.py:28-62`` runs them: the
    max error per engine, the max error of the edge agreements (which
    depend on W), the collectives per sweep call, and (rank 0)
    acceptance."""
    from repro_torch.core import engine
    from repro_torch.runtime import dist_gibbs as DG
    mesh = _mesh(shape)
    g, exact, exact_agree = exact_potts()
    a, b = edges(g)
    out = {}
    for name in ENGINES:
        kw = dict(lam=float(2 * g.psi ** 2)) if name == "min-gibbs" else {}
        eng = engine.make(name, g, mesh=mesh, sweep=S, **kw)
        assert eng.backend == "dist" and eng.updates_per_call == S
        st = eng.init(0, C)
        agree = torch.zeros(len(a))
        before = DG.all_reduce.calls
        for _ in range(calls):
            st = eng.sweep(st)
            agree += (st.x[:, a] == st.x[:, b]).sum(0)
        per_call = (DG.all_reduce.calls - before) / calls
        marg, acc = DG.gather_marginals(st, mesh)
        emp = marg.sum(0).numpy() / (st.count * C)
        agree = agreement(agree, mesh, calls * C)
        out[name] = dict(err=float(np.abs(emp - exact).max()),
                         agree_err=float(np.abs(agree - exact_agree).max()),
                         per_call=per_call, chains=int(st.x.shape[0]),
                         acc=float(acc.mean()) / (st.count * S))
    return out


def replay_rank(rank, world, shape, calls=6):
    """Each engine (uniform and adaptive) run twice from seed 3 on the
    potts 2x2 graph: True per engine when both runs' states are the same
    bits."""
    from repro_torch.core import engine
    mesh = _mesh(shape)
    g, _ = exact_potts_marginals()
    same = {}
    for name in ENGINES:
        for sched in (engine.UniformSites(4),
                      engine.AdaptiveScan(sweep_len=4, refresh_every=2)):
            eng = engine.make(name, g, mesh=mesh, schedule=sched)
            runs = []
            for _ in range(2):
                st = eng.init(3, 8)
                for _ in range(calls):
                    st = eng.sweep(st)
                runs.append(_bits(st))
            same[f"{name}/{type(sched).__name__}"] = all(
                np.array_equal(runs[0][k], runs[1][k]) for k in runs[0])
    return same


def adaptive_rank(rank, world, shape):
    """AdaptiveScan gibbs on hetero-pairs-24 over ``shape``, as
    ``tests/test_distributed.py:213-247``: the error against the uniform
    exact marginals, the error of each pair's agreement against its exact
    e^w / (e^w + D - 1), the table before and after, this data shard's
    hits and the collectives per call."""
    from repro_torch.core import engine
    from repro_torch.runtime import dist_gibbs as DG
    mesh = _mesh(shape)
    g = engine.make_workload("hetero-pairs-24", device="cpu").graph
    a, b = edges(g)
    w = g.W[a, b].double().numpy()
    exact_agree = np.exp(w) / (np.exp(w) + g.D - 1)
    C, S, calls = 32, 16, 500
    eng = engine.make("gibbs", g, mesh=mesh, schedule=engine.AdaptiveScan(
        sweep_len=S, refresh_every=4))
    st = eng.init(0, C)
    cdf0 = st.cdf.clone().numpy()
    agree = torch.zeros(len(a))
    before = DG.all_reduce.calls
    for _ in range(calls):
        st = eng.sweep(st)
        agree += (st.x[:, a] == st.x[:, b]).sum(0)
    per_call = (DG.all_reduce.calls - before) / calls
    marg, _ = DG.gather_marginals(st, mesh)
    emp = marg.sum(0).numpy() / (st.count * C)
    agree = agreement(agree, mesh, calls * C)
    return dict(err=float(np.abs(emp - 0.5).max()), cdf0=cdf0,
                cdf=st.cdf.numpy(), hits=float(st.hits.sum()),
                agree_err=float(np.abs(agree - exact_agree).max()),
                per_call=per_call)


def chromatic_rank(rank, world, shape, sweeps=2, C=2, seed=3):
    """Chromatic gibbs on lattice-ising-64x64 over ``shape`` against the
    dense reference driven by the same shared generator: whether each
    sweep's x is the same bits, and the collectives per call."""
    from repro_torch.core import engine
    from repro_torch.runtime import dist_gibbs as DG
    mesh = _mesh(shape)
    wl = engine.make_workload("lattice-ising-64x64", device="cpu")
    g = wl.graph
    eng = engine.make("gibbs", g, mesh=mesh,
                      schedule=engine.ChromaticBlocks(wl.colors))
    assert eng.updates_per_call == g.n
    st = eng.init(seed, C)
    dense = DG.make_chromatic_gibbs_step(g, wl.colors)
    gen = torch.Generator()
    gen.manual_seed(DG.shard_seeds(seed, 0, 0)[0])
    x_ref = torch.zeros((C, g.n), dtype=torch.int32)
    equal = []
    before = DG.all_reduce.calls
    for _ in range(sweeps):
        for c in range(2):
            x_ref = dense(x_ref, gen, c)
        st = eng.sweep(st)
        equal.append(bool(torch.equal(st.x, x_ref)))
    return dict(equal=equal, per_call=(DG.all_reduce.calls - before) / sweeps,
                moved=int((st.x != 0).sum()))


def telemetry_rank(rank, world, shape):
    """``Engine.sweep(state, telemetry)`` on the dist engines against the
    single-device engines on hetero-pairs-24 (``tests/test_distributed.py
    :250-289``): acceptance and the split-R-hat profile of each."""
    from repro_torch import diagnostics as diag
    from repro_torch.core import engine
    mesh = _mesh(shape)
    g = engine.make_workload("hetero-pairs-24", device="cpu").graph
    C, S, calls = 32, 8, 120
    out = {}
    for name in ENGINES:
        kw = dict(lam=256.0) if name == "min-gibbs" else {}
        res = {}
        for backend in ("torch", "dist"):
            bkw = dict(mesh=mesh) if backend == "dist" else dict(
                device="cpu")
            eng = engine.make(name, g, sweep=S, **kw, **bkw)
            st = eng.init(2, C)
            tel = eng.init_telemetry(st, half_at=calls // 2)
            for _ in range(calls):
                st, tel = eng.sweep(st, tel)
            res[backend] = (diag.acceptance_rate(tel, eng.exact_accept),
                            np.asarray(diag.split_rhat(tel)))
        out[name] = res
    return out


def gauges_rank(rank, world, shape, chains=8, sweep=8):
    """``Recorder.register_engine`` gauges of dist engines (every algorithm
    uniform, gibbs chromatic) beside ``psum_footprint``'s numbers."""
    from repro_torch import obs
    from repro_torch.core import engine
    from repro_torch.runtime.dist_gibbs import psum_footprint
    mesh = _mesh(shape)
    wl = engine.make_workload("hetero-pairs-24", device="cpu")
    out = []
    cases = [(n, engine.UniformSites(sweep)) for n in ENGINES]
    cases.append(("gibbs", engine.ChromaticBlocks(wl.colors)))
    for name, sched in cases:
        eng = engine.make(name, wl.graph, mesh=mesh, schedule=sched)
        rec = obs.Recorder()
        labels = rec.register_engine(eng, workload=wl.name, chains=chains)
        got = {k: rec.metrics.value(k, **labels) for k in (
            "collectives_per_sweep", "psum_payload_bytes")}
        if isinstance(sched, engine.ChromaticBlocks):
            want = psum_footprint("chromatic", C=chains, D=wl.graph.D,
                                  n=wl.graph.n, n_colors=sched.n_colors)
        else:
            want = psum_footprint(name, C=chains, D=wl.graph.D, S=sweep)
        out.append((name, labels["backend"], got, want))
    return out


def launcher_rank(rank, world, argv, capture):
    """The launcher's ``main(argv)`` on this rank, its standard output
    captured into ``capture`` + the rank number."""
    import contextlib
    from repro_torch.launch import gibbs
    with open(f"{capture}.{rank}", "w") as f, contextlib.redirect_stdout(f):
        gibbs.main(argv)
    return rank


# -- the supervised runtime on the dist backend ------------------------------

# the JAX package's dist crash-resume plan (tests/test_distributed.py:307-310)
CRASH_PLAN = ('{"faults": [{"step": 2, "kind": "corrupt", "target": '
              '"arrays"}, {"step": 2, "kind": "preempt"}, {"step": 4, '
              '"kind": "nan", "target": "x"}]}')


def potts_factory(mp, sweep=4):
    """``make_engine(name, ranks, **params)`` over potts 2x2 D=3 on a
    (len(ranks) / mp, mp) mesh, as the launcher's ``engine_factory`` builds
    it (the graph is no registered workload): None on a rank outside
    ``ranks``."""
    from repro_torch.core import engine
    from repro_torch.launch.mesh import make_device_mesh
    g, _ = exact_potts_marginals()

    def make_engine(name, ranks, **params):
        mesh = make_device_mesh((max(len(ranks) // mp, 1), mp),
                                ("data", "model"), ranks, device_type="cpu")
        if mesh is None:
            return None
        return engine.make(name, g, mesh=mesh, sweep=sweep, **params)
    return make_engine


def _summary(res):
    """The picklable parts of a RunResult."""
    return dict(left=res.left, restarts=res.restarts,
                rollbacks=res.rollbacks, outer_steps=res.outer_steps,
                kinds=[i["kind"] for i in res.incidents],
                incidents=[{k: v for k, v in i.items() if k != "time"}
                           for i in res.incidents],
                marginals=res.marginals,
                x=None if res.state is None else res.state.x.clone().numpy(),
                engine=None if res.engine is None else res.engine.name)


def supervised_rank(rank, world, shape, ckpt_root):
    """The supervised runtime on a (data, model) = ``shape`` mesh of gloo
    ranks: (a) the launcher's ``run_supervised`` on hetero-pairs-24 mgpmh
    clean and under :data:`CRASH_PLAN` (tests/test_distributed.py:292-317);
    (b) on potts 2x2 D=3, a device loss at outer step 3 keeping the first
    half of the ranks, 800 calls in all; the survivors' marginals and, from
    the committed steps' states, the edge agreements; (c) the survivors'
    later engine swaps, which the ranks that left take no part in: a
    shrink to half the ranks, then an acceptance-floor degrade to gibbs on
    the smaller mesh; and, on a (world, 1) mesh, two losses in a row."""
    import os
    from repro_torch.launch.gibbs import run_supervised
    from repro_torch.runtime.faultinject import Fault, FaultPlan
    from repro_torch.runtime.supervisor import SupervisedRun, SupervisorConfig
    # every group made from here on ends in a store barrier over the ranks
    # that must make it: a group that the whole world had to make would
    # wait for the ranks that left
    os.environ["TORCH_DIST_INIT_BARRIER"] = "1"
    dp, mp = shape
    kw = dict(steps=24, chains=16, mp_shards=mp, backend="dist", chunk=4,
              device="cpu")
    clean = run_supervised("hetero-pairs-24", "mgpmh",
                           ckpt_dir=os.path.join(ckpt_root, "clean"), **kw)
    fault = run_supervised("hetero-pairs-24", "mgpmh",
                           ckpt_dir=os.path.join(ckpt_root, "fault"),
                           fault_plan=CRASH_PLAN, **kw)
    g, exact, exact_agree = exact_potts()
    a, b = edges(g)
    agree, seen = torch.zeros(len(a)), []

    def on_step(step, bundle, tel, eng):
        nonlocal agree
        agree += (bundle.st.x[:, a] == bundle.st.x[:, b]).sum(0)
        seen.append(bundle.st.x.shape[0])

    keep = world // 2
    cfg = SupervisorConfig(outer_steps=100, sweeps_per_outer=8, chains=64,
                           seed=0, ckpt_dir=os.path.join(ckpt_root, "el"),
                           backoff_base=0.0)
    res = SupervisedRun("mgpmh", potts_factory(mp), cfg,
                        FaultPlan([Fault(step=3, kind="device-loss",
                                         keep=keep)]),
                        sleep_fn=lambda s: None, on_step=on_step).run()
    out = dict(clean=_summary(clean), fault=_summary(fault),
               elastic=_summary(res))
    if not res.left:
        from repro_torch.launch.mesh import mesh_coords
        mesh = res.engine.mesh
        out["elastic"]["err"] = float(np.abs(res.marginals - exact).max())
        out["elastic"]["agree_err"] = float(np.abs(
            agreement(agree, mesh, sum(seen) * mesh_coords(mesh)[1])
            - exact_agree).max())
    cfg = SupervisorConfig(outer_steps=6, sweeps_per_outer=2, chains=8,
                           ckpt_dir=os.path.join(ckpt_root, "shrink-degrade"),
                           backoff_base=0.0, acceptance_floor=2.0,
                           floor_after=2, max_strikes=1, retune=False)
    out["shrink_degrade"] = _summary(SupervisedRun(
        "mgpmh", potts_factory(mp), cfg,
        FaultPlan([Fault(step=1, kind="device-loss", keep=keep)]),
        sleep_fn=lambda s: None).run())
    cfg = SupervisorConfig(outer_steps=6, sweeps_per_outer=2, chains=8,
                           ckpt_dir=os.path.join(ckpt_root, "two-losses"),
                           backoff_base=0.0)
    out["two_losses"] = _summary(SupervisedRun(
        "mgpmh", potts_factory(1), cfg,
        FaultPlan([Fault(step=1, kind="device-loss", keep=world // 2),
                   Fault(step=3, kind="device-loss", keep=1)]),
        sleep_fn=lambda s: None).run())
    return out


def supervised_pair_rank(rank, world, ckpt_root):
    """On two ranks: (a) a 1x2 mesh losing a rank (keep=1 with mp=2): the
    error the run raises; (b) the launcher's ``run_supervised`` on a 2x1
    mesh (hetero-pairs-24 gibbs) losing rank 1: this rank's result; (c)
    the launcher's plain ``--ckpt-dir`` run on a 1x2 mesh, then rerun with
    more steps, and the same steps straight: this rank's output of each."""
    import contextlib
    import io
    import os
    from repro_torch.launch import gibbs
    from repro_torch.launch.gibbs import run_supervised
    from repro_torch.runtime.faultinject import Fault, FaultPlan
    from repro_torch.runtime.supervisor import SupervisedRun, SupervisorConfig
    cfg = SupervisorConfig(outer_steps=4, sweeps_per_outer=2, chains=8,
                           ckpt_dir=os.path.join(ckpt_root, "mp2"),
                           backoff_base=0.0)
    try:
        SupervisedRun("mgpmh", potts_factory(2), cfg,
                      FaultPlan([Fault(step=1, kind="device-loss", keep=1)]),
                      sleep_fn=lambda s: None).run()
        refusal = None
    except ValueError as e:
        refusal = str(e)
    plan = '{"faults": [{"step": 1, "kind": "device-loss", "keep": 1}]}'
    res = run_supervised("hetero-pairs-24", "gibbs", steps=16, chains=8,
                         sweep=4, chunk=4, mp_shards=1, backend="dist",
                         device="cpu", fault_plan=plan,
                         ckpt_dir=os.path.join(ckpt_root, "leave"))
    argv = ["--config", "hetero-pairs-24", "--engine", "mgpmh", "--chains",
            "8", "--sweep", "4", "--backend", "dist", "--mp-shards", "2",
            "--device", "cpu"]
    ck = ["--ckpt-dir", os.path.join(ckpt_root, "plain")]
    logs = []
    for extra in (ck + ["--steps", "6"], ck + ["--steps", "12"],
                  ["--steps", "12"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gibbs.main(argv + extra)
        logs.append(buf.getvalue())
    return dict(refusal=refusal, launcher=_summary(res), plain=logs)


# -- gradient compression (test_torch_optim.py) ----------------------------

def compressed_rank(rank, world, xs, errs):
    """Two ``compressed_psum_mean`` calls, the second on x / 2 with the
    first's error feedback; returns (mean, err, mean2, err2) as numpy and
    whether a length the ranks do not divide was refused by name."""
    from repro_torch.runtime.compression import compressed_psum_mean
    mean, err = compressed_psum_mean(torch.from_numpy(xs[rank]),
                                     torch.from_numpy(errs[rank]))
    mean2, err2 = compressed_psum_mean(torch.from_numpy(xs[rank]) * 0.5, err)
    try:
        compressed_psum_mean(torch.zeros(5), torch.zeros(5))
        refused = False
    except ValueError as e:
        refused = "divide" in str(e)
    return [t.numpy() for t in (mean, err, mean2, err2)], refused
