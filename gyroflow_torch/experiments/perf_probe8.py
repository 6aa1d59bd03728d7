"""Probe 8: what a plain elementwise pass reaches (a Triton kernel).

The counterpart of ``experiments/perf_probe8.py``, whose four Pallas calls
(:39, :55, :75, :100) run elementwise chains over 5400 tiles of 1536
float32 values, as (1, 1536) rows or (8, 192) blocks:

- ``chain``: 25 rounds of ``x * 1.000001 + 0.5`` then ``max(x - 0.25, 0)``
  (the probe's ~100 operations), on the rows and on the blocks;
- ``chain_plus1``: ``chain(x) + 1``, written as (1, 1536) rows (the probe's
  in-kernel relayout);
- ``sum10``: ``sum over i < 10 of (x + i)``, accumulated from 0 in order.

The TPU question was the layout of a tile in vector registers; on the card
the (1, 1536) and (8, 192) shapes are the same bytes, so both are launches
of one flat kernel, and the readings say what bandwidth a pass with no reuse
reaches. ``elementwise`` launches a Triton kernel (one program per 1024
values, the variant a compile-time constant, fp fusion off so each multiply
and add rounds as the plain torch ops do); ``elementwise_plain`` is the same
function in torch. Triton is imported at the first launch.

``elementwise`` checks its input, then runs the plain version for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
``elementwise.launches`` counts kernel launches.
"""
import functools
import json

import numpy as np
import torch

from . import perf_probe as pp

VARIANTS = {"chain": 0, "chain_plus1": 1, "sum10": 2}
NOPS = 100
BLOCK = 1024
FULL = (5400, 1536)                # tiles, values per tile
SMALL = (16, 1536)
tl = None                          # triton.language, bound at the first launch


def elementwise_plain(x, variant: str):
    """Plain torch: the variant over x; ``chain`` keeps x's shape, the other
    two return (x.shape[0], 1, n) rows."""
    if variant == "sum10":
        acc = torch.zeros_like(x)
        for i in range(10):
            acc = acc + (x + float(i))
    else:
        acc = x
        for _ in range(NOPS // 4):
            acc = acc * 1.000001 + 0.5
            acc = torch.clamp_min(acc - 0.25, 0.0)
        if variant == "chain_plus1":
            acc = acc + 1.0
    return acc if variant == "chain" else acc.reshape(x.shape[0], 1, -1)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The Triton kernel, compiled per variant at its first launch."""
    global tl
    import triton
    import triton.language

    tl = triton.language

    @triton.jit
    def elementwise_kernel(x_ptr, out_ptr, n, VARIANT: tl.constexpr, NCHAIN: tl.constexpr,
                           BLOCK_N: tl.constexpr):
        offs = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask, other=0.0)
        if VARIANT == 2:
            acc = tl.zeros_like(x)
            for i in tl.static_range(10):
                acc = acc + (x + i)
        else:
            acc = x
            for _ in tl.static_range(NCHAIN):
                acc = acc * 1.000001 + 0.5
                acc = tl.maximum(acc - 0.25, 0.0)
            if VARIANT == 1:
                acc = acc + 1.0
        tl.store(out_ptr + offs, acc, mask=mask)

    return triton, elementwise_kernel


def elementwise(x, variant: str):
    """The variant over float32 x (ntiles, ...); the output as in
    ``elementwise_plain``."""
    if variant not in VARIANTS:
        raise ValueError(f"elementwise: variant {variant!r} ({', '.join(VARIANTS)})")
    if x.dtype != torch.float32 or x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"elementwise: x must be contiguous float32 (ntiles, ...), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return elementwise_plain(x, variant)
    if x.device.type != "cuda":
        raise ValueError(f"elementwise: unsupported device {x.device}")
    triton, kernel = _kernel()
    out = torch.empty(x.shape if variant == "chain" else (x.shape[0], 1, x[0].numel()),
                      dtype=torch.float32, device=x.device)
    n = x.numel()
    if n:
        with torch.cuda.device(x.device):
            kernel[(triton.cdiv(n, BLOCK),)](x, out, n, VARIANT=VARIANTS[variant],
                                             NCHAIN=NOPS // 4, BLOCK_N=BLOCK, num_warps=4,
                                             enable_fp_fusion=False)
        elementwise.launches += 1
    return out


elementwise.launches = 0


def inputs(device, small: bool = False):
    """(x1 (ntiles, 1, P), x8 (ntiles, 8, P / 8)): the probe's inputs. Both
    are uniform [0, 1) from seed 0 there, so they hold the same values; x8
    is a view of x1's buffer."""
    ntiles, P = SMALL if small else FULL
    x1 = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (ntiles, 1, P))
                          .astype(np.float32)).to(device)
    return x1, x1.view(ntiles, 8, P // 8)


# (reading, input, variant): the probe's four calls
CALLS = (("rows (1,1536) x100ops", 0, "chain"), ("blocks (8,192) x100ops", 1, "chain"),
         ("blocks+1 relayout", 1, "chain_plus1"), ("blocks+10 relayouts", 1, "sum10"))


def run(device, small: bool = False) -> dict:
    xs = inputs(device, small)
    res, launches = {}, {}
    with pp.counting(launches, elementwise=elementwise):
        for key, which, variant in CALLS:
            res[key] = pp.cuda_ms(lambda: elementwise(xs[which], variant), device)
    res["bytes per call"] = 2 * xs[0].numel() * 4
    res["launches"] = launches
    return res


if __name__ == "__main__":
    print(json.dumps(run("cuda:0"), indent=1))
