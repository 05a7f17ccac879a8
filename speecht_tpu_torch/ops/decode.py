"""CTC decoders: greedy decode and the blank collapse before a beam.

Counterpart of ``speecht_tpu/ops/decode.py``. :func:`greedy_decode` is the
reference's ``tf.nn.ctc_greedy_decoder`` with ``merge_repeated=True``:
per-frame argmax, invalid frames become blank, repeats collapse against
the masked previous frame, blanks drop. Output is dense rows padded with
``PAD_ID`` plus lengths, all on the logits' device.

``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does, so ties
(common in bf16 logits upcast to f32) resolve the same way.

:func:`blank_collapse` drops the frames whose blank probability is above a
threshold before the beam search ("Blank Collapse: Compressing CTC
emission for the faster decoding", arXiv:2210.17017), in stock torch ops
on the logits' device, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from speecht_tpu_torch import vocabulary


def greedy_decode(
    logits: torch.Tensor, logit_lengths: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy CTC decode.

    Args:
      logits: [B, T, C] (or log-probs; only the argmax is used).
      logit_lengths: [B] valid frame counts.

    Returns:
      (decoded [B, T] int32 padded with PAD_ID, lengths [B] int32,
       neg_sum_logits [B]: minus the sum over valid frames of the max
       logit, tf.nn.ctc_greedy_decoder's log_probability output).
    """
    B, T, _C = logits.shape
    best = logits.argmax(dim=-1).to(torch.int32)
    best_val = logits.amax(dim=-1)
    t_idx = torch.arange(T, device=logits.device)[None, :]
    valid = t_idx < logit_lengths[:, None]
    best = torch.where(valid, best, vocabulary.BLANK_ID)

    prev = F.pad(best[:, :-1], (1, 0), value=-1)
    keep = (best != vocabulary.BLANK_ID) & (best != prev) & valid

    # compact kept symbols to the front of each row; dropped ones go to
    # the extra column T, which is cut off
    pos = torch.cumsum(keep, dim=1) - 1
    pos = torch.where(keep, pos, T)
    out = torch.full(
        (B, T + 1), vocabulary.PAD_ID, dtype=torch.int32, device=logits.device
    )
    out.scatter_(1, pos, torch.where(keep, best, vocabulary.PAD_ID))
    lengths = keep.sum(dim=1).to(torch.int32)

    neg_sum_logits = -torch.where(valid, best_val, 0.0).sum(dim=1)
    return out[:, :T], lengths, neg_sum_logits


def blank_collapse(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    blank_threshold: float = 0.999,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop the valid frames whose blank probability is not below
    ``blank_threshold`` and move the kept ones to the front of each row.

    Returns (float32 log-probs [B, T, C], zero past each row's kept
    frames; new lengths [B] int32).
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    B, T, C = logp.shape
    t_idx = torch.arange(T, device=logp.device)[None, :]
    valid = t_idx < logit_lengths[:, None]
    keep = valid & (logp[..., vocabulary.BLANK_ID].exp() < blank_threshold)

    # dropped frames go to the extra frame T, which is cut off
    pos = torch.cumsum(keep, dim=1) - 1
    pos = torch.where(keep, pos, T)
    out = torch.zeros(B, T + 1, C, dtype=logp.dtype, device=logp.device)
    out.scatter_(1, pos[..., None].expand(B, T, C), logp)
    new_lengths = keep.sum(dim=1).to(torch.int32)
    return out[:, :T].contiguous(), new_lengths
