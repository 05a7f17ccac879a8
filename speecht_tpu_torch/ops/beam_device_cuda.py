"""The LM-fused CTC prefix beam on the card: the wrapper of
``csrc/beam_device.cu``.

The kernel replaces the XLA ``lax.scan`` of
``speecht_tpu/ops/beam_device.py:1228`` (no Pallas kernel): one CTA per
row runs the whole frame loop, so a batch is one launch. Its plain version
is ``ops/beam_device.py::plain_beam_search``; ``make_device_beam_search``
takes that only for log-probs on the CPU and calls :data:`BEAM_DEVICE` for
log-probs on a CUDA device, which launches the kernel or raises.

A frame is a chain of block barriers, so the kernel keeps the chain
short (the source's header has the details): the frames' top-K is ranked
a chunk of 32 frames ahead into a shared ring; the merge probes a shared
hash table of the alive prefixes once; the top W of the (K+1)·W pool are
found by a radix select of order-preserving 32-bit keys, ties at the
threshold kept by candidate index (the plain version's stable sort, JAX's
``lax.top_k``), and only those W are ranked; the LM bonus travels with
the slot, so only a letter extension walks the LM, on spare warps while
the owners publish and merge; the backpointers stay in shared memory where
[T, W] int16 fits (else in a [B, T, W] global scratch this wrapper allocates).

The library's limits are held here too, as Python constants equal to
``csrc/beam_device.cu``'s (``kMaxW``, the 65535-candidate cap,
``kMaxSmem``) with a twin of ``beam_device_smem_bytes`` (the kernel's
``Layout``), so that ``ops/beam.py`` decides from the flags alone, before
it loads an LM or builds the library, whether ``--device-beam`` can take
a width (:func:`shape_limits`). The launch-time
:meth:`BeamDeviceKernel.check_shape` asks the library itself.
:data:`BEAM_DEVICE_SPLIT` is the same source built with
``-DBEAM_DEVICE_SPLIT`` (a split of a frame's time by phase), which only
``chip_smoke.py`` loads.
"""

from __future__ import annotations

import ctypes

import torch

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.ops import cuda_build
from speecht_tpu_torch.ops.beam_device import BeamSpec, fusion_weights

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# csrc/beam_device.cu's kMaxW, the candidate index's 16-bit range,
# kMaxSmem, kMaxH, kMaxC, kChunk and kPasses
MAX_WIDTH = 1024
MAX_CANDIDATES = 0xFFFF
MAX_SMEM = 232448
MAX_HIST = 5
MAX_CLASSES = 32
FRAME_CHUNK = 32
RADIX_PASSES = 5


def smem_bytes(W: int, K: int, H: int) -> int:
    """``beam_device_smem_bytes`` in Python: the kernel's ``Layout``, each
    region rounded up to 16 bytes (a launch adds the LM threads' requests
    and the backpointers where they fit)."""
    cells = 1 << max(0, (2 * W - 1).bit_length())  # next_pow2(2W)
    regions = (
        2 * FRAME_CHUNK * ((5 * K + 36 + 15) & ~15),  # the frame ring
        6 * W * 4, 6 * W * 4, 5 * W * 4,  # the published beam state
        W * max(H, 1) * 4, W,  # word history, has-a-merge flags
        W * K * 2,  # the merge map
        cells * 4,  # the prefix hash table
        (K + 1) * W * 4,  # the pool's keys
        RADIX_PASSES * 256 * 4, 32 * 4, 16,  # histograms, warp sums, 2 keys
        W * 4, W * 2,  # the kept list: keys, candidate indices
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
        # the backpointers' global scratch, only where [T, W] int16 does not
        # fit in shared memory beside the layout (the kernel's own test)
        bp = None
        if (self.lib.beam_device_smem_bytes(W, K, H) + 2 * T * W
                > self.lib.beam_device_max_smem()):
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
            None if bp is None else bp.data_ptr(), ids.data_ptr(), lens.data_ptr(),
            scores.data_ptr(),
            cuda_build.device_index(device),
            torch.cuda.current_stream(device).cuda_stream,
        )
        self._raise_on(code)
        self.launches += 1
        if n == 1:
            return ids[:, 0], lens[:, 0]
        return ids, lens, scores


# the phases of a frame that the split build times, in the order of
# beam_device_split_read's columns
SPLIT_PHASES = ("frame load and top-K", "publish", "merge", "scoring", "selection",
                "re-index", "LM probes", "backtrack")


class BeamDeviceSplit(BeamDeviceKernel):
    """``csrc/beam_device.cu`` built a second time with
    ``-DBEAM_DEVICE_SPLIT``: the same search, where thread 0 of each CTA
    adds up ``clock64()`` intervals of the frame's phases
    (:data:`SPLIT_PHASES`). No CLI path loads it; ``chip_smoke.py`` phase 2d
    does, to say where a frame's time goes."""

    defines = ("BEAM_DEVICE_SPLIT",)
    signatures = BeamDeviceKernel.signatures + (
        ("beam_device_split_read", [_P, _I], _I),
    )

    def split(self, rows: int) -> torch.Tensor:
        """The last launch's split of its first ``rows`` rows, int64
        [rows, len(SPLIT_PHASES) + 4]: each phase's cycles summed over the
        row's frames, thread 0's cycles waiting at barriers (within those
        phases), the radix passes, the row's cycles in all, its frames."""
        out = torch.empty(rows, len(SPLIT_PHASES) + 4, dtype=torch.int64)
        self._raise_on(self.lib.beam_device_split_read(out.data_ptr(), rows))
        return out


BEAM_DEVICE = BeamDeviceKernel()
BEAM_DEVICE_SPLIT = BeamDeviceSplit()
KERNELS = (BEAM_DEVICE,)
