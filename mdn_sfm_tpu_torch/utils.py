"""Small runtime utilities."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another. Raises when CUDA is asked for (explicitly or by default) and is
    missing — an entry point never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def use_full_f32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits), which is too coarse for the f32 parity runs and for the
    epipolar geometry; the bf16 runs go through autocast and are unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def divisor(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``x``'s type on its device, to divide by.
    On the card PyTorch divides by a Python number as a multiply by its
    reciprocal, which rounds otherwise than an IEEE division (the CPU's, the
    kernels', XLA's); by a tensor it divides."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def eval_chunks(n: int, batch_size: int):
    """Yield (indices, n_valid) for batched eval over ``n`` samples.

    ``indices`` always has length ``batch_size``: the last chunk is padded by
    repeating its last index, so every batch has one shape. Callers use only
    the first ``n_valid`` results; batching changes throughput, not results."""
    bs = max(1, batch_size)
    for start in range(0, n, bs):
        idxs = list(range(start, min(start + bs, n)))
        n_valid = len(idxs)
        idxs += [idxs[-1]] * (bs - n_valid)
        yield idxs, n_valid
