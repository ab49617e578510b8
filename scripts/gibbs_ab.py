#!/usr/bin/env python3
"""The Gibbs sweep kernels of several checkouts, timed on one card.

  python3 scripts/gibbs_ab.py PARENT_ROOT CHANGE_ROOT [MORE_ROOTS ...]

The first process builds potts-64x64's and lattice-ising-64x64's W (and
the lattice's coloring) once and saves them under ``build/gibbs_ab/``.
Each checkout (a directory holding ``src/repro_torch``) then runs in a
process of its own, in the order given and then back (parent, change,
change, parent), builds its kernels from its own sources and times, on
inputs drawn on the card from fixed seeds:

  * the uniform-site Gibbs kernel at potts-64x64 (C=256, S=64, D=10),
    and at C=128 (one block per SM);
  * one chromatic class of lattice-ising-64x64 (C=256, |class| = 2048,
    D=2) through the sequential Gibbs kernel (the parent's chromatic
    path) and, where the checkout has it, through the class kernel
    (``kernels/chromatic_sweep.py``), beside the class's byte bound;
  * the class's library yardstick: one float32 ``torch.matmul`` of
    W[class] (2048 x 4096) by the one-hot state (4096 x C*D), plus the
    Gumbels and the argmax, TF32 off (used nowhere in the port).

Each reading is the median of CUDA-event times of single calls; the class
kernel is also timed as a stream of launches and as device time alone
(``torch.profiler``), since its host path is a large part of one call.
Every run prints the kernels' registers, spills and shared memory
(``-Xptxas -v``) and hashes the outputs: on both classes the class kernel
must equal the sequential kernel bit for bit (all lattice weights are 0.8,
and any order of summing at most four of them gives the same float), and
every checkout's sequential result must be the same.  Prints one JSON line
per run and the card's name and power limit, and writes them all to
``chiprun_out/gibbs_ab.json``.  Needs one CUDA card; imports nothing of
JAX.
"""
import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GRAPHS = ROOT / "build" / "gibbs_ab" / "graphs.pt"
C, S = 256, 64
REPS = dict(uniform=20, sequential=5, class_kernel=50, library=20)


def save_graphs():
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import engine
    potts = engine.make_workload("potts-64x64", device="cpu").graph
    lat = engine.make_workload("lattice-ising-64x64", device="cpu")
    GRAPHS.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(potts_W=potts.W, potts_D=potts.D, lattice_W=lat.graph.W,
                    lattice_D=lat.graph.D,
                    colors=torch.from_numpy(lat.colors)), GRAPHS)


def digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def ptxas(log):
    """{entry: "registers; spills; shared memory"} of the Gibbs kernels."""
    lines, out = log.splitlines(), {}
    for k, ln in enumerate(lines):
        hit = re.search(r"\d\d(gibbs_(?:class_)?sweep_kernel(?:ILi\d+E)?)", ln)
        if "entry function" in ln and hit:
            name = hit.group(1)
            out[name] = "; ".join(
                x.split(":", 1)[-1].strip() for x in lines[k + 1:k + 4]
                if "spill" in x or "registers" in x)
    return out


def time_tree(tree):
    """Readings of the checkout at ``tree``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs        # puts ROOT/src on sys.path first ...
    import torch
    sys.path.insert(0, str(Path(tree).resolve() / "src"))   # ... then tree
    from repro_torch.kernels import _build, fused_sweep as fs
    try:
        from repro_torch.kernels import chromatic_sweep as chs
    except ImportError:            # a checkout from before the class kernel
        chs = None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    built = _build.load_library()
    t = torch.load(GRAPHS)
    W, D = t["potts_W"].to(dev), t["potts_D"]
    n = W.shape[0]
    gen = torch.Generator(device=dev).manual_seed(41)

    def gumbel(shape):
        u = torch.rand(shape, generator=gen, device=dev)
        return -torch.log(-torch.log(u + 1e-20) + 1e-20)

    out = {}
    x = torch.randint(0, D, (C, n), generator=gen, device=dev,
                      dtype=torch.int32)
    i = torch.randint(0, n, (C, S), generator=gen, device=dev,
                      dtype=torch.int32)
    g = gumbel((C, S, D))
    bms, by = cs.bound(*cs.gibbs_bound(x, W, i, g))
    ms, res = cs.timed(lambda: fs.gibbs_sweep_cuda(x, W, i, g, D=D),
                       REPS["uniform"])
    torch.cuda.synchronize()
    out["gibbs_sweep"] = dict(
        shape=f"potts-64x64 C={C} S={S} D={D}", ms=ms, bound_ms=bms,
        bound_by=by, outputs=digest(res),
        plan=(fs.gibbs_ring_plan(n, D) if hasattr(fs, "gibbs_ring_plan")
              else None))
    # at C=128 one block per SM: another block cannot hide a row's latency
    C2 = C // 2
    x2, i2, g2 = (v[:C2].contiguous() for v in (x, i, g))
    ms, res = cs.timed(lambda: fs.gibbs_sweep_cuda(x2, W, i2, g2, D=D),
                       REPS["uniform"])
    out[f"gibbs_sweep C={C2}"] = dict(ms=ms, outputs=digest(res))
    del W, res
    W, D = t["lattice_W"].to(dev), t["lattice_D"]
    colors = t["colors"].to(dev)
    x = torch.randint(0, D, (C, n), generator=gen, device=dev,
                      dtype=torch.int32)
    same = True
    for k in range(2):
        sites = torch.nonzero(colors == k).flatten().to(torch.int32)
        m = sites.numel()
        g = gumbel((C, m, D))
        seq_i = sites.expand(C, -1).contiguous()
        shape = f"lattice-ising-64x64 class {k} C={C} m={m} D={D}"
        reps = REPS["sequential"] if k == 0 else 1
        ms, seq = cs.timed(lambda: fs.gibbs_sweep_cuda(x, W, seq_i, g, D=D),
                           reps)
        rec = dict(shape=shape, sequential_ms=ms, sequential=digest(seq))
        if chs is not None:
            from repro_torch.core.factor_graph import MatchGraph
            graph = MatchGraph(W=W, D=D, psi=0.0, L=0.0, delta=4,
                               row_sum=W.sum(1))
            off, recs = graph.nbr_pack
            xk = x.clone()
            f = lambda: chs.gibbs_class_sweep_cuda(xk, off, recs, sites, g,
                                                   D=D)
            if k == 0:
                rec["ms"], _ = cs.timed(f, REPS["class_kernel"])
                rec["per_launch_ms"] = cs.per_launch_ms(f, 20)
                rec["device_ms"] = cs.kernel_device_ms(f, 20,
                                                       "gibbs_class")
                rec["bound_ms"], rec["bound_by"] = cs.bound(
                    *cs.gibbs_class_bound(x, off, sites, g))
                rec["library_ms"], v = cs.timed(
                    cs.class_library(W, x, sites, g), REPS["library"])
                rec["library_equal"] = bool(torch.equal(
                    v.T.to(torch.int32), seq[:, sites.long()]))
            else:
                f()
            torch.cuda.synchronize()
            rec["class_kernel"] = digest(xk)
            same &= rec["class_kernel"] == rec["sequential"]
        out[f"class {k}"] = rec
        x = seq                       # class 1 reads class 0's update
    return dict(tree=str(tree), module=fs.__file__,
                ptxas=ptxas(built.log) if built.log else "reused",
                tf32=torch.backends.cuda.matmul.allow_tf32,
                class_kernel_equals_sequential=same if chs else None,
                kernels=out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.trees[0])))
        return 0
    if len(args.trees) < 2:
        ap.error("give the parent's and the change's checkout")
    import torch
    if not torch.cuda.is_available():
        print("gibbs_ab: no CUDA device", file=sys.stderr)
        return 1
    save_graphs()
    runs = []
    for tree in args.trees + args.trees[::-1]:
        res = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    checks = dict(
        class_kernel_equals_sequential=all(
            r["class_kernel_equals_sequential"] in (True, None)
            for r in runs),
        sequential_same_everywhere=all(
            len({r["kernels"][f"class {k}"]["sequential"] for r in runs}) == 1
            for k in range(2)),
        uniform_outputs={r["tree"]: r["kernels"]["gibbs_sweep"]["outputs"]
                         for r in runs})
    print(json.dumps(checks))
    print(smi)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "gibbs_ab.json").write_text(
        json.dumps(dict(card=smi, checks=checks, runs=runs), indent=1))
    return 0 if (checks["class_kernel_equals_sequential"]
                 and checks["sequential_same_everywhere"]) else 1


if __name__ == "__main__":
    sys.exit(main())
