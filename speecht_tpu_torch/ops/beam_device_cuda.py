"""The LM-fused CTC prefix beam on the card: the wrapper of
``csrc/beam_device.cu``.

The kernel replaces the XLA ``lax.scan`` of
``speecht_tpu/ops/beam_device.py:1228`` (no Pallas kernel): one CTA per
row runs the whole frame loop, so a batch is one launch. Its plain version
is ``ops/beam_device.py::plain_beam_search``; ``make_device_beam_search``
takes that only for log-probs on the CPU and calls :data:`BEAM_DEVICE` for
log-probs on a CUDA device, which launches the kernel or raises.

The library's limits are held here too, as Python constants equal to
``csrc/beam_device.cu``'s (``kMaxW``, the 65535-candidate cap,
``kMaxSmem``) with a twin of ``beam_device_smem_bytes``, so that
``ops/beam.py`` decides from the flags alone, before it loads an LM or
builds the library, whether ``--device-beam`` can take a width
(:func:`shape_limits`). The launch-time :meth:`BeamDeviceKernel.check_shape`
asks the library itself.
"""

from __future__ import annotations

import ctypes

import torch

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.ops import cuda_build
from speecht_tpu_torch.ops.beam_device import BeamSpec, fusion_weights

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# csrc/beam_device.cu:65-66: kMaxW, the candidate index's int16 range,
# kMaxSmem, kMaxH, kMaxC
MAX_WIDTH = 1024
MAX_CANDIDATES = 0xFFFF
MAX_SMEM = 232448
MAX_HIST = 5
MAX_CLASSES = 32


def smem_bytes(W: int, K: int, H: int) -> int:
    """``beam_device_smem_bytes`` in Python: the kernel's ``Layout``, each
    region rounded up to 16 bytes."""
    P2 = 1 << max(0, ((K + 1) * W - 1).bit_length())  # next_pow2((K+1)W)
    regions = (
        MAX_CLASSES * 4, MAX_CLASSES * 4, MAX_CLASSES * 4,  # frame, top-K
        6 * W * 4, 6 * W * 4, 5 * W * 4,  # the published beam state
        W * max(H, 1) * 4, W,  # word history, has-word flags
        W * K * 2,  # the merge map
        P2 * 4, P2 * 2,  # sort keys, indices
    )
    total = 0
    for n in regions:
        total = (total + n + 15) & ~15
    return total


def shape_limits(W: int, K: int, H: int) -> list[str]:
    """The kernel's limits that beam width W, top-K K and history H
    pass, each as a phrase; empty when the kernel takes the shape."""
    limits = []
    if W > MAX_WIDTH:
        limits.append(f"beam width {W} is more than the kernel's {MAX_WIDTH}")
    if (K + 1) * W > MAX_CANDIDATES:
        limits.append(f"(top-k {K} + 1) x beam width {W} candidates is more "
                      f"than {MAX_CANDIDATES}")
    smem = smem_bytes(W, K, H)
    if smem > MAX_SMEM:
        limits.append(f"beam width {W} at top-k {K} needs {smem} bytes of "
                      f"shared memory per block, more than the card's {MAX_SMEM}")
    return limits


class BeamDeviceKernel(cuda_build.KernelLibrary):
    """``csrc/beam_device.cu``: the whole beam search of a batch."""

    name = "beam_device"
    signatures = (
        (
            "beam_device_search",
            [_P, _P] + [_I] * 13 + [_F] * 4 + [_P, _I, _P, _P, _I, _I, _P, _P, _I, _I]
            + [_P] * 4 + [_I, _P],
            _I,
        ),
        ("beam_device_smem_bytes", [_I, _I, _I], ctypes.c_size_t),
        ("beam_device_threads", [_I, _I], _I),
        ("beam_device_max_width", [], _I),
        ("beam_device_max_smem", [], _I),
        ("beam_device_error_string", [_I], ctypes.c_char_p),
    )

    def check_shape(self, W: int, K: int, H: int) -> None:
        """Raises, naming the limit, for a width the kernel cannot take."""
        most = self.lib.beam_device_max_width()
        if W > most:
            raise ValueError(f"{self.name}: beam width {W} is more than {most}")
        if (K + 1) * W > 0xFFFF:
            raise ValueError(
                f"{self.name}: (top-k {K} + 1) x beam width {W} candidates "
                "is more than 65535"
            )
        smem = self.lib.beam_device_smem_bytes(W, K, H)
        limit = self.lib.beam_device_max_smem()
        if smem > limit:
            raise ValueError(
                f"{self.name}: beam width {W} at top-k {K} needs {smem} bytes "
                f"of shared memory per block, more than the card's {limit}"
            )

    def __call__(self, spec: BeamSpec, logp: torch.Tensor, lengths: torch.Tensor,
                 lm_weight, word_count_weight, valid_word_count_weight):
        """The search of ``ops/beam_device.make_device_beam_search`` on the
        card: log-probs [B, T, C] float32, lengths [B] int32, both on one
        CUDA device with the LM's tables."""
        device = logp.device
        if device.type != "cuda":
            raise ValueError(f"{self.name} runs on a CUDA device, not {device}")
        if logp.dtype != torch.float32 or logp.dim() != 3:
            raise ValueError("logp must be float32 [B, T, C]")
        B, T, C = logp.shape
        if T == 0:
            raise ValueError("logp has no frames")
        if not vocabulary.BLANK_ID < C <= 32:
            raise ValueError(f"{self.name} takes 29 to 32 classes, not {C}")
        if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
            raise ValueError(f"lengths must be int32 ({B},)")
        W, K, H, lm = spec.W, spec.top_k(C), spec.H, spec.lm
        tables = [] if lm is None else [lm.tables[k] for k in (
            "uni", "arena_k", "arena_v", "words_k", "words_v")]
        for t in [logp, lengths, *tables]:
            if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(
                    f"{self.name} needs contiguous, 16-byte aligned tensors on "
                    "one device (the log-probs, the lengths and the LM tables)"
                )
        if any(t.dtype != torch.int32 for t in tables):
            raise ValueError(f"{self.name}: the LM tables must be int32")
        if tables:
            # the kernel reads buckets of 4 slots, each 2 int32 key words
            # and 2 value words, and unigram rows of 3
            uni, arena_k, arena_v, words_k, words_v = tables
            for label, t in (("arena_k", arena_k), ("arena_v", arena_v),
                             ("words_k", words_k), ("words_v", words_v)):
                if t.dim() != 3 or tuple(t.shape[1:]) != (4, 2):
                    raise ValueError(f"{self.name}: {label} must be [N, 4, 2], "
                                     f"not {list(t.shape)}")
            if uni.dim() != 2 or uni.shape[1] != 3:
                raise ValueError(f"{self.name}: uni must be [V, 3], not {list(uni.shape)}")
        self.check_shape(W, K, H)

        lm_ln10, wc_w, vwc_w = fusion_weights(
            lm_weight, word_count_weight, valid_word_count_weight
        )
        n = spec.n_best
        ids = torch.empty(B, n, T, dtype=torch.int32, device=device)
        lens = torch.empty(B, n, dtype=torch.int32, device=device)
        scores = torch.empty(B, n, dtype=torch.float32, device=device)
        bp = torch.empty(B, T, W, dtype=torch.int16, device=device)
        if lm is None:
            lm_args = [0, H, 0, spec.bos_id, 0, 0, spec.hcnt_cap,
                       0.0, lm_ln10, wc_w, vwc_w,
                       None, 0, None, None, 0, 0, None, None, 0, 0]
        else:
            uni, arena_k, arena_v, words_k, words_v = tables
            lm_args = [
                1, H, int(lm.key_scheme == "kenlm"), spec.bos_id, lm.unk_id,
                int(spec.pin_bos), spec.hcnt_cap, lm.unk_floor, lm_ln10, wc_w,
                vwc_w, uni.data_ptr(), uni.shape[0], arena_k.data_ptr(),
                arena_v.data_ptr(), arena_k.shape[0], int(lm.arena_two_choice),
                words_k.data_ptr(), words_v.data_ptr(), words_k.shape[0],
                int(lm.words_two_choice),
            ]
        code = self.lib.beam_device_search(
            logp.data_ptr(), lengths.data_ptr(), B, T, C, W, K, n, *lm_args,
            bp.data_ptr(), ids.data_ptr(), lens.data_ptr(), scores.data_ptr(),
            cuda_build.device_index(device),
            torch.cuda.current_stream(device).cuda_stream,
        )
        self._raise_on(code)
        self.launches += 1
        if n == 1:
            return ids[:, 0], lens[:, 0]
        return ids, lens, scores


BEAM_DEVICE = BeamDeviceKernel()
KERNELS = (BEAM_DEVICE,)
