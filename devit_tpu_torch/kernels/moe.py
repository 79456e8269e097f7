"""The sparse-expert layer's dispatch and combine (models/moe.py) as two
hand-written kernels, `moe_gather_rows` and `moe_combine_rows`
(csrc/moe.cu), each with an eager path of the same layout contract.

Two index maps make every direction a gather with one writer an output:
  tok_slot (T, K) int32: the slot (expert * cap + position) of token t's
                         j-th choice, -1 where capacity dropped it;
  slot_tok (S,) int32:   the token in slot s (S = experts * cap), -1 where
                         the slot is empty.

  moe_gather(x, slot_tok)                 out[s] = x[slot_tok[s]] (zeros where
                                          empty): the dispatch
  moe_gather(dy, slot_tok, tok_slot, w)   out[s] = w[t, j] dy[t] for the choice
                                          (t, j) that fills s: the combine's
                                          backward for the slot buffer
  moe_combine(buf, tok_slot, w)           y[t] = sum_j w[t, j] buf[slot(t, j)],
                                          in j order, dropped choices skipped:
                                          the combine (w None: weight 1, the
                                          dispatch's backward)
  moe_combine_dw(dy, buf, tok_slot)       dw[t, j] = <dy[t], buf[slot(t, j)]>
                                          in f32: the combine's backward for
                                          the weights

A CUDA tensor takes the kernels (each launch counted in `moe_gather.launches`
or `moe_combine.launches`, moe_combine_dw's among the latter); a CPU tensor
takes the eager path (`reference_*`). Values are float32, bfloat16 or
float16 (another dtype raises TypeError, as the attention wrappers do), the
weights float32. The gather and the weighted combine compute each product
and sum in f32, rounded on its own, and round once to the values' dtype, so
on the card the kernels equal the eager path bit for bit; the dot products
of moe_combine_dw sum in another order (a warp reduction).
"""

from __future__ import annotations

from typing import Optional

import torch

from devit_tpu_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_DTYPES = tuple(_DTYPE_CODES)
MAX_K = 8  # choices a token the kernels take (csrc/moe.cu kMaxK)


def _check(values: torch.Tensor, *maps: Optional[torch.Tensor],
           w: Optional[torch.Tensor] = None) -> None:
    if values.dtype not in _DTYPE_CODES:
        raise TypeError(f"the MoE dispatch and combine take {KERNEL_DTYPES}, got {values.dtype}")
    for m in maps:
        if m is not None and m.dtype != torch.int32:
            raise TypeError(f"the MoE index maps are int32, got {m.dtype}")
    if w is not None and w.dtype != torch.float32:
        raise TypeError(f"the MoE combine weights are float32, got {w.dtype}")
    if values.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the MoE dispatch and combine run on cuda (kernels) or cpu "
                         f"(eager), not {values.device}")


def _slot_weights(slot_tok: torch.Tensor, tok_slot: torch.Tensor, w: torch.Tensor):
    """The weight of the choice that fills each slot (0 where empty)."""
    S = slot_tok.shape[0]
    t = slot_tok.clamp_min(0).long()
    match = tok_slot[t] == torch.arange(S, device=slot_tok.device, dtype=torch.int32)[:, None]
    return torch.where(match, w[t], torch.zeros((), device=w.device)).sum(1)


def reference_gather(x: torch.Tensor, slot_tok: torch.Tensor,
                     tok_slot: Optional[torch.Tensor] = None,
                     w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """moe_gather's eager path (module docstring)."""
    filled = (slot_tok >= 0)[:, None]
    rows = x[slot_tok.clamp_min(0).long()]
    if w is not None:
        rows = (_slot_weights(slot_tok, tok_slot, w)[:, None] * rows.float()).to(x.dtype)
    return torch.where(filled, rows, torch.zeros((), dtype=x.dtype, device=x.device))


def reference_combine(buf: torch.Tensor, tok_slot: torch.Tensor,
                      w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """moe_combine's eager path: an f32 sum over the choices in j order."""
    acc = torch.zeros((tok_slot.shape[0], buf.shape[1]), device=buf.device)
    for j in range(tok_slot.shape[1]):
        s = tok_slot[:, j]
        row = buf[s.clamp_min(0).long()].float()
        p = row if w is None else w[:, j:j + 1] * row
        acc = acc + torch.where((s >= 0)[:, None], p, 0.0)
    return acc.to(buf.dtype)


def reference_combine_dw(dy: torch.Tensor, buf: torch.Tensor,
                         tok_slot: torch.Tensor) -> torch.Tensor:
    """moe_combine_dw's eager path."""
    out = []
    for j in range(tok_slot.shape[1]):
        s = tok_slot[:, j]
        d = (dy.float() * buf[s.clamp_min(0).long()].float()).sum(-1)
        out.append(torch.where(s >= 0, d, 0.0))
    return torch.stack(out, 1)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(counted, name: str, *args) -> None:
    _build.check_launch(getattr(_build.library(), name)(*args), name)
    counted.launches += 1


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def moe_gather(x: torch.Tensor, slot_tok: torch.Tensor, tok_slot: Optional[torch.Tensor] = None,
               w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, C) rows of x (T, C) by slot_tok, times the filling choice's weight
    where w (T, K) is given (module docstring)."""
    _check(x, slot_tok, tok_slot, w=w)
    if w is not None and tok_slot is None:
        raise ValueError("a weighted gather needs tok_slot")
    if x.device.type == "cpu":
        return reference_gather(x, slot_tok, tok_slot, w)
    x, slot_tok = x.contiguous(), slot_tok.contiguous()
    S, C = slot_tok.shape[0], x.shape[1]
    out = torch.empty((S, C), dtype=x.dtype, device=x.device)
    if S and C:
        K = 1 if tok_slot is None else tok_slot.shape[1]
        if w is not None:
            tok_slot, w = tok_slot.contiguous(), w.contiguous()
        with torch.cuda.device(x.device):
            _launch(moe_gather, "devit_moe_gather", x.data_ptr(), slot_tok.data_ptr(),
                    _ptr(tok_slot) if w is not None else None, _ptr(w), out.data_ptr(), S, K,
                    C, _DTYPE_CODES[x.dtype], _stream(x))
    return out


moe_gather.launches = 0


def _combine(buf, tok_slot, w, dy, out, dw) -> None:
    T, K = tok_slot.shape
    if K > MAX_K:
        raise ValueError(f"the MoE combine takes at most {MAX_K} choices a token, got {K}")
    with torch.cuda.device(buf.device):
        _launch(moe_combine, "devit_moe_combine", buf.data_ptr(), tok_slot.data_ptr(), _ptr(w),
                _ptr(dy), _ptr(out), _ptr(dw), T, K, buf.shape[1], _DTYPE_CODES[buf.dtype],
                _stream(buf))


def moe_combine(buf: torch.Tensor, tok_slot: torch.Tensor,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, C): each token's kept choices' rows of buf (S, C), weighted by w
    (T, K) (weight 1 where w is None), summed in j order (module
    docstring)."""
    _check(buf, tok_slot, w=w)
    if buf.device.type == "cpu":
        return reference_combine(buf, tok_slot, w)
    buf, tok_slot = buf.contiguous(), tok_slot.contiguous()
    w = None if w is None else w.contiguous()
    out = torch.empty((tok_slot.shape[0], buf.shape[1]), dtype=buf.dtype, device=buf.device)
    if out.numel() and tok_slot.shape[1]:
        _combine(buf, tok_slot, w, None, out, None)
    elif out.numel():
        out.zero_()
    return out


moe_combine.launches = 0


def moe_combine_dw(dy: torch.Tensor, buf: torch.Tensor, tok_slot: torch.Tensor) -> torch.Tensor:
    """(T, K) f32: the dot of dy[t] with the row of each kept choice, 0
    where dropped (module docstring); a launch counts in
    `moe_combine.launches`."""
    _check(buf, tok_slot)
    if dy.dtype != buf.dtype:
        raise TypeError(f"dy {dy.dtype} does not match the buffer's {buf.dtype}")
    if buf.device.type == "cpu":
        return reference_combine_dw(dy, buf, tok_slot)
    dy, buf, tok_slot = dy.contiguous(), buf.contiguous(), tok_slot.contiguous()
    dw = torch.zeros(tuple(tok_slot.shape), dtype=torch.float32, device=buf.device)
    if tok_slot.numel() and buf.shape[1]:
        _combine(buf, tok_slot, None, dy, None, dw)
    return dw
