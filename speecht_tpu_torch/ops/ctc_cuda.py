"""CTC loss and its gradient on the card: the wrappers of the CUDA kernels.

Counterpart of ``speecht_tpu/ops/ctc_pallas.py``: ``csrc/ctc_alpha.cu``
replaces the TPU kernel ``ctc_pallas.py::_forward_kernel`` and
``csrc/ctc_beta.cu`` replaces ``ctc_pallas.py::_backward_kernel`` together
with the class scatter and ``g * softmax`` term that ``_bwd_rule`` leaves
to XLA, so it writes dlogits directly.

:func:`ctc_loss` takes the plain version (``ops/ctc.py``) only for tensors
on the CPU. For a CUDA tensor it launches the kernels or raises: there is
no fallback and no shape cut-off. When a gradient is needed it goes
through :class:`CtcLossCuda`, whose forward has the alpha kernel write its
``[T, B, S]`` history and whose backward is the beta kernel; otherwise
(``evaluate`` under ``inference_mode``) no history is written. The
log-softmax stays a torch op before the kernels, as the JAX package leaves
it to XLA.
"""

from __future__ import annotations

import ctypes

import torch

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.ops import ctc as ctc_plain
from speecht_tpu_torch.ops import cuda_build

# the card's limit on dynamic shared memory for one block (227 KB)
MAX_SMEM_BYTES = 232448


def _check_inputs(name, log_probs, logit_lengths, labels, label_lengths):
    """Validates what both kernels take; returns (B, T, C, L)."""
    device = log_probs.device
    if device.type != "cuda":
        raise ValueError(f"{name} runs on a CUDA device, not {device}")
    if log_probs.dtype != torch.float32 or log_probs.dim() != 3:
        raise ValueError("log_probs must be float32 [B, T, C]")
    B, T, C = log_probs.shape
    if T == 0:
        raise ValueError("log_probs has no frames")
    if labels.dim() != 2 or labels.shape[0] != B:
        raise ValueError(f"labels must be [B={B}, L], got {tuple(labels.shape)}")
    L = labels.shape[1]
    for arg, t, shape in (
        ("labels", labels, (B, L)),
        ("logit_lengths", logit_lengths, (B,)),
        ("label_lengths", label_lengths, (B,)),
    ):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{arg} must be int32 {shape}")
    return B, T, C, L


def _check_placed(name, device, tensors):
    for t in tensors:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors on one device")


def _check_smem(name, smem, L):
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name}: label width {L} needs {smem} bytes of shared memory "
            f"per block, more than the card's {MAX_SMEM_BYTES}"
        )


def _check_states(name, S, L, most):
    if S > most:
        raise ValueError(
            f"{name}: {S} CTC states (label width {L}) is more than one "
            f"block takes ({most})"
        )


_P, _I = ctypes.c_void_p, ctypes.c_int


class CtcAlphaKernel(cuda_build.KernelLibrary):
    """``csrc/ctc_alpha.cu``: the per-example loss and the alpha history."""

    name = "ctc_alpha"
    signatures = (
        ("ctc_alpha_forward", [_P] * 6 + [_I] * 6 + [_P], _I),
        ("ctc_alpha_smem_bytes", [_I, _I], ctypes.c_size_t),
        ("ctc_alpha_max_states", [], _I),
        ("ctc_alpha_error_string", [_I], ctypes.c_char_p),
    )

    def __call__(
        self,
        log_probs: torch.Tensor,
        logit_lengths: torch.Tensor,
        labels: torch.Tensor,
        label_lengths: torch.Tensor,
        alpha_out: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Per-example loss [B] from log-probs [B, T, C] on the card.

        ``labels`` is [B, L] int32, the lengths [B] int32. When
        ``alpha_out`` ([T, B, 2L+1] float32) is given, the kernel also
        writes the alpha history into it.
        """
        device = log_probs.device
        B, T, C, L = _check_inputs(
            self.name, log_probs, logit_lengths, labels, label_lengths
        )
        S = 2 * L + 1
        if alpha_out is not None and (
            alpha_out.dtype != torch.float32 or tuple(alpha_out.shape) != (T, B, S)
        ):
            raise ValueError(f"alpha_out must be float32 {(T, B, S)}")
        tensors = [log_probs, labels, logit_lengths, label_lengths]
        if alpha_out is not None:
            tensors.append(alpha_out)
        _check_placed(self.name, device, tensors)
        _check_states(self.name, S, L, self.lib.ctc_alpha_max_states())
        _check_smem(self.name, self.lib.ctc_alpha_smem_bytes(L, C), L)

        loss = torch.empty(B, dtype=torch.float32, device=device)
        code = self.lib.ctc_alpha_forward(
            log_probs.data_ptr(),
            labels.data_ptr(),
            logit_lengths.data_ptr(),
            label_lengths.data_ptr(),
            loss.data_ptr(),
            alpha_out.data_ptr() if alpha_out is not None else None,
            B, T, C, L,
            vocabulary.BLANK_ID,
            cuda_build.device_index(device),
            torch.cuda.current_stream(device).cuda_stream,
        )
        self._raise_on(code)
        self.launches += 1
        return loss


class CtcBetaKernel(cuda_build.KernelLibrary):
    """``csrc/ctc_beta.cu``: dlogits from the alpha history, by the beta
    recursion, the state posteriors and their scatter onto the classes."""

    name = "ctc_beta"
    signatures = (
        ("ctc_beta_backward", [_P] * 8 + [_I] * 6 + [_P], _I),
        ("ctc_beta_smem_bytes", [_I, _I], ctypes.c_size_t),
        ("ctc_beta_max_states", [], _I),
        ("ctc_beta_error_string", [_I], ctypes.c_char_p),
    )

    def __call__(
        self,
        log_probs: torch.Tensor,
        logit_lengths: torch.Tensor,
        labels: torch.Tensor,
        label_lengths: torch.Tensor,
        alpha: torch.Tensor,
        loss: torch.Tensor,
        grad: torch.Tensor,
    ) -> torch.Tensor:
        """dlogits [B, T, C] float32 on the card.

        ``alpha`` is the [T, B, 2L+1] float32 history the alpha kernel
        wrote, ``loss`` its [B] losses (logP = -loss) and ``grad`` the [B]
        float32 cotangent of the losses.
        """
        device = log_probs.device
        B, T, C, L = _check_inputs(
            self.name, log_probs, logit_lengths, labels, label_lengths
        )
        S = 2 * L + 1
        if alpha.dtype != torch.float32 or tuple(alpha.shape) != (T, B, S):
            raise ValueError(f"alpha must be float32 {(T, B, S)}")
        for arg, t in (("loss", loss), ("grad", grad)):
            if t.dtype != torch.float32 or tuple(t.shape) != (B,):
                raise ValueError(f"{arg} must be float32 {(B,)}")
        _check_placed(
            self.name, device,
            [log_probs, labels, logit_lengths, label_lengths, alpha, loss, grad],
        )
        _check_states(self.name, S, L, self.lib.ctc_beta_max_states())
        _check_smem(self.name, self.lib.ctc_beta_smem_bytes(L, C), L)

        dlogits = torch.empty(B, T, C, dtype=torch.float32, device=device)
        code = self.lib.ctc_beta_backward(
            log_probs.data_ptr(),
            labels.data_ptr(),
            logit_lengths.data_ptr(),
            label_lengths.data_ptr(),
            alpha.data_ptr(),
            loss.data_ptr(),
            grad.data_ptr(),
            dlogits.data_ptr(),
            B, T, C, L,
            vocabulary.BLANK_ID,
            cuda_build.device_index(device),
            torch.cuda.current_stream(device).cuda_stream,
        )
        self._raise_on(code)
        self.launches += 1
        return dlogits


CTC_ALPHA = CtcAlphaKernel()
CTC_BETA = CtcBetaKernel()
KERNELS = (CTC_ALPHA, CTC_BETA)


class CtcLossCuda(torch.autograd.Function):
    """Per-example CTC loss on the card, differentiable in the logits.

    Forward: log-softmax, then the alpha kernel with its history written;
    it saves the log-probs [B, T, C], the history [T, B, 2L+1] and the
    loss. Backward: the beta kernel writes dlogits.
    """

    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths):
        log_probs = torch.log_softmax(logits.float(), dim=-1).contiguous()
        B, T, _C = log_probs.shape
        alpha = torch.empty(
            T, B, 2 * labels.shape[1] + 1, dtype=torch.float32,
            device=log_probs.device,
        )
        loss = CTC_ALPHA(log_probs, logit_lengths, labels, label_lengths, alpha)
        ctx.save_for_backward(
            log_probs, logit_lengths, labels, label_lengths, alpha, loss
        )
        ctx.logits_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        log_probs, logit_lengths, labels, label_lengths, alpha, loss = (
            ctx.saved_tensors
        )
        dlogits = CTC_BETA(
            log_probs, logit_lengths, labels, label_lengths, alpha, loss,
            g.float().contiguous(),
        )
        return dlogits.to(ctx.logits_dtype), None, None, None


def ctc_loss(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
) -> torch.Tensor:
    """Per-example CTC loss; same API as ``ops/ctc.py::ctc_loss``.

    CPU tensors take the plain version; CUDA tensors the kernels, through
    :class:`CtcLossCuda` when a gradient is needed.
    """
    if logits.device.type == "cpu":
        return ctc_plain.ctc_loss(logits, logit_lengths, labels, label_lengths)
    args = (
        logit_lengths.to(torch.int32).contiguous(),
        labels.to(torch.int32).contiguous(),
        label_lengths.to(torch.int32).contiguous(),
    )
    if torch.is_grad_enabled() and logits.requires_grad:
        return CtcLossCuda.apply(logits, *args)
    log_probs = torch.log_softmax(logits.float(), dim=-1).contiguous()
    return CTC_ALPHA(log_probs, *args)
