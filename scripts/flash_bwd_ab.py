#!/usr/bin/env python3
"""The flash-attention backward kernel of two checkouts, timed on one card.

  python3 scripts/flash_bwd_ab.py PARENT_ROOT CHANGE_ROOT

Each checkout (a directory holding ``src/repro_torch``) runs in a process
of its own, in the order parent, change, change, parent, builds its
kernels from its own sources and times its ``flash_attention_bwd_cuda`` at
the model shapes of ``chip_smoke.BWD_SHAPES`` (tinyllama-1.1b's training
attention, h2o-danube-3-4b's window, gemma3-12b's local and global
layers) on the same
seeded inputs and the checkout's own forward row statistics (lse2): the
CUDA-event median per call of ``chip_smoke.py`` phase 12a and each
kernel's device time (``torch.profiler``).  Each run also times
``scaled_dot_product_attention``'s backward (fwd + bwd minus fwd, a band
mask where a window is set, else its fused causal path), which no checkout
calls.  Prints one JSON
line per run, the card's name and power limit, and writes them all to
``chiprun_out/flash_bwd_ab.json``.  Needs one CUDA card; imports nothing
of JAX.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_tree(tree):
    """{shape: {ms, kernel_device_ms, library_ms}} for the checkout at
    ``tree``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs        # puts ROOT/src on sys.path first ...
    import torch
    sys.path.insert(0, str(Path(tree).resolve() / "src"))   # ... then tree
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    out = {}
    for n, (B, Sq, Sk, H, KVH, hd, w, causal) in enumerate(
            cs.BWD_SHAPES[:cs.BWD_MODEL_SHAPES]):
        q, k, v = cs.flash_inputs(B, Sq, Sk, H, KVH, hd, torch.bfloat16, dev,
                                  seed=70 + 2 * n)
        dout = cs.flash_inputs(B, Sq, Sq, H, H, hd, torch.bfloat16, dev,
                               seed=71 + 2 * n)[0]
        o, lse2 = fa.flash_attention_cuda(q, k, v, window=w, causal=causal,
                                          lse=True)
        bwd = lambda: fa.flash_attention_bwd_cuda(q, k, v, o, dout, lse2,
                                                  window=w, causal=causal)
        ms = cs.per_launch_ms(bwd, 5, reps=5)
        ev, _ = cs.device_events(lambda: [bwd() for _ in range(3)])
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dt = dout.transpose(1, 2)
        mask = None
        if w > 0:
            i = torch.arange(Sq, device=dev)[:, None]
            j = torch.arange(Sk, device=dev)[None, :]
            mask = (i - j < w) & (i >= j) if causal else i - j < w
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        lib = (cs.per_launch_ms(
            lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dt), 5)
            - cs.per_launch_ms(sdpa, 5))
        out[f"B={B} Sq={Sq} Sk={Sk} H={H} KVH={KVH} hd={hd} window={w}"] = \
            dict(ms=ms, kernel_device_ms=cs.bwd_kernel_ms(ev, 3),
                 library_ms=lib)
        del q, k, v, dout, o, lse2, qt, kt, vt, dt, mask
        torch.cuda.empty_cache()
    return dict(tree=str(tree), module=fa.__file__, shapes=out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.parent)))
        return 0
    if args.change is None:
        ap.error("give the parent's and the change's checkout")
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    runs = []
    for tree in (args.parent, args.change, args.change, args.parent):
        res = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "flash_bwd_ab.json").write_text(
        json.dumps(dict(card=smi, runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
