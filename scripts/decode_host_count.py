#!/usr/bin/env python3
"""Count the host work of one decode step over a mesh, on the CPU.

A narrow qwen3-4b at its full depth (d_model 64, 36 layers), 8 prompts
of 16 tokens, prefilled over a ``(data, model)`` mesh of CPU slots; then
one warm decode step, and a second one counted twice: the Python calls
it makes (``sys.setprofile``) and the aten ops it dispatches (a
``TorchDispatchMode``).  The widths are narrow so that the host's share
shows; the counts do not depend on the machine, so two trees compare
without a card.

    PYTHONPATH=src python scripts/decode_host_count.py [--mesh 1x2,2x1]
        [--src path/to/other/src]
"""

import argparse
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1x2,2x1")
    ap.add_argument("--src", default=os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import LM
    from repro_torch.serve.step import make_decode, make_prefill

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            Ops.n += 1
            return func(*a, **(kw or {}))

    cfg = get_config("qwen3-4b").replace(
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=256, dtype="float32")
    prompts = torch.randint(0, 256, (8, 16),
                            generator=torch.Generator().manual_seed(0))
    for name in args.mesh.split(","):
        data, model_size = (int(v) for v in name.split("x"))
        model = LM(cfg, device="cpu", seed=0)
        mesh = make_host_mesh(data=data, model=model_size, device="cpu")
        prefill = make_prefill(model, 24, mesh=mesh)
        decode = make_decode(model, mesh=mesh)
        cache, nxt = prefill(prompts)
        tok, cache = decode(cache, nxt[:, None], 16)
        calls = [0]

        def count(frame, event, arg):
            if event in ("call", "c_call"):
                calls[0] += 1
        sys.setprofile(count)
        decode(cache, tok, 17)
        sys.setprofile(None)
        Ops.n = 0
        with Ops():
            decode(cache, tok, 17)
        print(f"{args.src} {name}: decode step {Ops.n} aten ops, "
              f"{calls[0]} Python calls", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
