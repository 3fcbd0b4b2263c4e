"""What the check must refuse: the program in a lower precision than the
configuration states (the control), and faults planted under the timed
path (the CPU tests, and `calibrate.py`'s upper readings on the card).

The control is TF32, the precision below f32 with TF32 off. The port
has a switch of its own for it (`allow_tf32` for cuBLAS and cuDNN), and
the control turns it on; but the clients' grouped convolutions run in
cuDNN's SIMT f32 kernels either way, so the switch alone leaves most of
a round in f32. So the control also rounds every input of every
convolution and matrix product of the client models to TF32's 10-bit
mantissa (`tf32_inputs`), as a TF32 kernel would read them.

The faults are `wrap_program`s for `harness.Options`: each wraps the
round program's global and gossip rounds."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to nearest at TF32's 10-bit mantissa (Veltkamp's split
    at 2^13 + 1); differentiable, its gradient the identity's."""
    c = t * 8193.0
    return c - (c - t)


class TF32Inputs(TorchFunctionMode):
    """Rounds the floating-point tensor arguments of the convolutions and
    matrix products called inside it to TF32."""
    OPS = (F.conv1d, F.conv2d, F.linear, torch.matmul, torch.bmm,
           torch.Tensor.__matmul__)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            args = tuple(to_tf32(a) if isinstance(a, torch.Tensor)
                         and a.is_floating_point() else a for a in args)
        return func(*args, **(kwargs or {}))


def tf32_inputs(apply_fn):
    """`apply_fn` with its convolutions and products read in TF32."""
    def apply(params, x):
        with TF32Inputs():
            return apply_fn(params, x)
    return apply



def wrap_rounds(fn):
    """RoundProgram -> the same with each round called through
    fn(round_fn, state, *args, **kwargs)."""
    def wrap(program):
        def g(*a, **k):
            return fn(program.global_round, *a, **k)

        def s(*a, **k):
            return fn(program.gossip_round, *a, **k)

        return program._replace(
            global_round=g,
            gossip_round=s if program.gossip_round else None)
    return wrap


def unchanged(round_fn, state, *a, **k):
    """A step that returns its state unchanged."""
    new, cache, metrics = round_fn(state, *a, **k)
    return (new._replace(params=state.params, opt_state=state.opt_state),
            cache, metrics)


def half_batch(local_steps: int, local_batch: int):
    """Half of each minibatch left out, the mean taken over the rest: the
    round's own minibatch draw with its second half a copy of the
    first."""
    def fault(round_fn, state, data, *a, **k):
        from repro_torch.core.protocol import UPDATE_STREAM, round_generator
        m, n_local = data["x_train"].shape[:2]
        idx = torch.randint(0, n_local,
                            (m, local_steps, min(local_batch, n_local)),
                            generator=round_generator(state.seed, state.round,
                                                      UPDATE_STREAM))
        half = idx.shape[-1] // 2
        idx[..., half:2 * half] = idx[..., :half]
        return round_fn(state, data, *a, batch_idx=idx, **k)
    return fault


def altered_answer(round_fn, state, *a, **k):
    """One bit of one announced code flipped where it is produced."""
    new, cache, metrics = round_fn(state, *a, **k)
    codes = new.codes.clone()
    codes[0, 0] ^= 1
    return new._replace(codes=codes), cache, metrics


FAULTS = {"unchanged": lambda proto: wrap_rounds(unchanged),
          "half_batch": lambda proto: wrap_rounds(half_batch(
              proto["local_steps"], proto["local_batch"])),
          "altered_answer": lambda proto: wrap_rounds(altered_answer)}
