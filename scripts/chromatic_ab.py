#!/usr/bin/env python3
"""The chromatic Gibbs class kernel and the chromatic sweep call of several
checkouts, timed on one card.

  python3 scripts/chromatic_ab.py [--once] TREE [TREE ...]

A TREE is a directory holding ``src/repro_torch`` (a checkout, or the
parent unpacked with ``git archive`` into the ignored ``build/``),
optionally followed by ``@`` and ``+``-joined levers, each a throwaway
edit of its ``csrc/chromatic_sweep.cu`` made in a copy under
``build/chromatic_ab/trees/``:

  * ``const:NAME=VALUE`` sets ``constexpr int NAME`` (e.g.
    ``.@const:kChainBatch=8``);
  * a name in ``LEVERS``: the kernel this one replaced (a thread per
    (chain, site) item, fed Gumbels) with its x
    gathers replaced by a value of the record (``no_gather``), its record
    loads replaced by a record made from the index (``no_record_loads``),
    or its stores never taken (``no_store``); this kernel with its x
    gathers replaced so (``new_no_gather``), or its Gumbel transform
    dropped, the uniforms taken as they are (``no_transform``).

The first process builds lattice-ising-64x64's W and coloring once and
saves them under ``build/chromatic_ab/``.  Each tree then runs in a process
of its own, in the order given and then back (parent, change, change,
parent; ``--once``: in the order given only), builds its kernels from its
own sources and, on inputs drawn on the card from fixed seeds, reads:

  * the class kernel on class 0 (C=256, |class| = 2048, D=2): device time
    alone (``torch.profiler``), per launch as a stream of 20, a single
    call, beside the byte bound; a tree whose kernel takes uniforms is fed
    the uniforms, an older one their Gumbels (``samplers.gumbel``'s
    operations on the same uniforms), and the two must write the same
    class (the output hash);
  * the kernel's registers and spills (``-Xptxas -v``), its resident
    blocks an SM (the launch plan where the tree has one, else from the
    registers) and its SASS (``cuobjdump``, written to
    ``chiprun_out/chromatic_ab/``);
  * the engine's whole chromatic sweep call (``engine.make("gibbs", g,
    schedule=ChromaticBlocks(colors))``): its time, a stream of calls with
    the device's busy time and idle share, its device ops per call;
  * the state hash after 20 engine calls from one seed, which must be the
    same in every tree without levers.

Prints one JSON line per run and the card's name and power limit, and
writes them all to ``chiprun_out/chromatic_ab.json`` (``--out``).  Needs
one CUDA card; imports nothing of JAX.
"""
import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "chromatic_ab"
GRAPH = WORK / "lattice.pt"
OUT = ROOT / "chiprun_out" / "chromatic_ab"
C, CALLS = 256, 20
SOURCE = Path("src/repro_torch/kernels/csrc/chromatic_sweep.cu")
# throwaway edits of a kernel: (old, new) pairs; the first three of the
# one this kernel replaced (a thread per (chain, site) item), the last two
# of this one
LEVERS = {
    # the x gathers: the value of the record's j instead of x[c, j]
    "no_gather": [("const int v = xc[e.x] - u0;",
                   "const int v = (e.x & 1) - u0;")],
    # the record loads: a record made from its index (j near the row's
    # site, as on the lattice: about four records a row)
    "no_record_loads": [("const int2 e = __ldg(rec + r);",
                         "const int2 e = make_int2(r >> 2, 0x3f4ccccd);")],
    # the stores: computed, never taken (D = 2 never gives 12345)
    "no_store": [("    xc[i] = site_update_thread<kD>(xc, rec, lo, hi, "
                  "gumbel + item * D, D);",
                  "    const int nv = site_update_thread<kD>(xc, rec, lo, "
                  "hi, gumbel + item * D, D);\n    if (nv == 12345) "
                  "xc[i] = nv;")],
    "new_no_gather": [("v[t][q] = xc[static_cast<long long>(t) * n + rj[q]];",
                       "v[t][q] = rj[q] & 1;")],
    "no_transform": [("return -logf(-logf(fmaxf(u, FLT_MIN)));",
                      "return u;")],
}


def digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def save_graph():
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import engine
    wl = engine.make_workload("lattice-ising-64x64", device="cpu")
    WORK.mkdir(parents=True, exist_ok=True)
    torch.save(dict(W=wl.graph.W, D=wl.graph.D,
                    colors=torch.from_numpy(wl.colors)), GRAPH)


def lever_tree(spec):
    """The directory to import for ``spec`` (``PATH`` or
    ``PATH@lever+lever``): PATH itself, or a copy of its ``src`` with the
    levers applied."""
    path, _, levers = spec.partition("@")
    if not levers:
        return Path(path).resolve()
    label = re.sub(r"[^A-Za-z0-9_.=+-]", "_", spec)
    dst = WORK / "trees" / label
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(Path(path) / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / SOURCE
    text = cu.read_text()
    for lever in levers.split("+"):
        if lever.startswith("const:"):
            name, value = lever[len("const:"):].split("=")
            text, hits = re.subn(rf"(constexpr int {name} = )[^;]+;",
                                 rf"\g<1>{value};", text)
            if hits != 1:
                raise SystemExit(f"lever {lever}: no constexpr int {name} "
                                 f"in {cu}")
            continue
        for old, new in LEVERS[lever]:
            if old not in text:
                raise SystemExit(f"lever {lever}: {old!r} not in {cu}")
            text = text.replace(old, new)
    cu.write_text(text)
    return dst


def ptxas(log):
    """{entry: "registers; spills"} of the class kernel's instances."""
    lines, out = log.splitlines(), {}
    for k, ln in enumerate(lines):
        hit = re.search(r"(gibbs_class_sweep_kernel\w*)", ln)
        if "entry function" in ln and hit:
            out[hit.group(1)] = "; ".join(
                x.split(":", 1)[-1].strip() for x in lines[k + 1:k + 4]
                if "spill" in x or "registers" in x)
    return out


def blocks_from_registers(info, threads=256):
    """Resident blocks an SM of an H100 for the kD=2 instance of a kernel
    without a launch plan (the parent's: blocks of 256 threads), from its
    registers (a thread's rounded up to 8; 64K registers, 2048 threads);
    None where the library was reused (no ptxas output)."""
    for name, text in (info.items() if isinstance(info, dict) else ()):
        if "ILi2E" in name:
            regs = int(re.search(r"Used (\d+) registers", text).group(1))
            warps = min(64, 65536 // (-(-regs // 8) * 8 * 32))
            return min(warps // (threads // 32), 2048 // threads)
    return None


def sass(lib_path, label):
    """The class kernel's SASS from the built library, to a file."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              timeout=120).stdout
    except OSError as e:
        return f"cuobjdump not run: {e}"
    keep, out = False, []
    for ln in text.splitlines():
        if "Function :" in ln:
            keep = "gibbs_class_sweep_kernel" in ln
        if keep:
            out.append(ln)
    OUT.mkdir(parents=True, exist_ok=True)
    dst = OUT / f"sass_{re.sub(r'[^A-Za-z0-9_.=+-]', '_', label)}.txt"
    dst.write_text("\n".join(out))
    return str(dst.relative_to(ROOT))


def time_tree(spec):
    """Readings of the tree ``spec``."""
    tree = lever_tree(spec)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs        # puts ROOT/src on sys.path first ...
    import torch
    sys.path.insert(0, str(tree / "src"))   # ... then the tree's
    from repro_torch.core import engine, factor_graph as tfg
    from repro_torch.kernels import _build, chromatic_sweep as chs, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    built = _build.load_library()
    t = torch.load(GRAPH)
    W, D, colors = t["W"].to(dev), t["D"], t["colors"].numpy()
    graph = tfg.MatchGraph(W=W, D=D, psi=0.0, L=0.0, delta=4,
                           row_sum=W.sum(1))
    off, recs = graph.nbr_pack
    takes_uniforms = hasattr(ref, "gumbel_from_uniform")
    gen = torch.Generator(device=dev).manual_seed(41)
    x = torch.randint(0, D, (C, graph.n), generator=gen, device=dev,
                      dtype=torch.int32)
    sites = torch.as_tensor((colors == 0).nonzero()[0], dtype=torch.int32,
                            device=dev)
    u = torch.rand((C, sites.numel(), D), generator=gen, device=dev)
    g = u.clone().clamp_min_(torch.finfo(torch.float32).tiny)
    g = g.log_().neg_().log_().neg_()
    noise = u if takes_uniforms else g
    out = dict(tree=spec, module=chs.__file__, takes_uniforms=takes_uniforms)
    first = chs.gibbs_class_sweep_cuda(x.clone(), off, recs, sites, noise,
                                       D=D)
    want = ref.gibbs_class_sweep_ref(x, W, sites, g, D)
    torch.cuda.synchronize()
    out["class_output"] = digest(first)
    out["equals_plain"] = bool(torch.equal(first, want))
    xk = x.clone()
    f = lambda: chs.gibbs_class_sweep_cuda(xk, off, recs, sites, noise, D=D)
    out["device_ms"] = cs.kernel_device_ms(f, 20, "gibbs_class")
    out["per_launch_ms"] = cs.per_launch_ms(f, 20)
    out["single_call_ms"] = cs.median_ms(f, 50)
    out["bound_ms"], out["bound_by"] = cs.bound(
        *cs.gibbs_class_bound(x, off, sites, u))
    out["ptxas"] = info = ptxas(built.log) if built.log else "reused"
    out["plan"] = (chs.gibbs_class_plan(C, sites.numel(), D)
                   if hasattr(chs, "gibbs_class_plan") else
                   dict(blocks_per_sm=blocks_from_registers(info)))
    out["sass"] = sass(built.path, spec)
    # the engine's chromatic sweep call
    eng = engine.make("gibbs", graph,
                      schedule=engine.ChromaticBlocks(colors))
    st = eng.init(3, C, start="random")
    call = cs.call_trace(lambda: eng.sweep(st), {})
    out["call"] = {k: v for k, v in call.items() if k != "parts"}
    out["call"]["device_ops_per_call"] = cs.device_ops_per_call(
        lambda: eng.sweep(st))
    st = eng.init(0, C, start="random")
    for _ in range(CALLS):
        st = eng.sweep(st)
    torch.cuda.synchronize()
    out["state_hash"] = digest(st.x)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--once", action="store_true",
                    help="each tree once, in the order given")
    ap.add_argument("--out", default="chromatic_ab.json",
                    help="the record's name under chiprun_out/")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.trees[0])))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chromatic_ab: no CUDA device", file=sys.stderr)
        return 1
    save_graph()
    order = args.trees if args.once else args.trees + args.trees[::-1]
    runs = []
    for tree in order:
        res = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True)
        if res.returncode:
            print(f"chromatic_ab: {tree} failed", file=sys.stderr)
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    plain = [r for r in runs if "@" not in r["tree"]]
    checks = dict(
        equals_plain=all(r["equals_plain"] for r in plain),
        same_class_output=len({r["class_output"] for r in plain}) <= 1,
        same_state_hash=len({r["state_hash"] for r in plain}) <= 1)
    print(json.dumps(checks))
    print(smi)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / args.out).write_text(
        json.dumps(dict(card=smi, checks=checks, runs=runs), indent=1))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
