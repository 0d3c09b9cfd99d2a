"""CTC fine-tuning: the train step on one device.

Counterpart of `wav2vec2_tpu.parallel.train`: wav2vec2 forward (bf16
compute over f32 weights) → f32 log-softmax → CTC loss → AdamW. PyTorch
runs eagerly, so `make_train_step` returns a plain function where the JAX
package returns a jitted one, and the optimizer updates the leaves in
place where optax returns a new tree.

- **Weights.** `init_train_state` copies every leaf as an f32 tensor that
  requires grad: the JAX package's f32 leaf set, all of it. The forward
  casts each weight to the compute dtype where it is consumed, inside the
  autograd graph, so the gradients reach the f32 leaves; norms, their
  statistics and the loss stay f32.
- **Optimizer.** `make_optimizer` is `optax.adamw`'s: lr 1e-4, betas
  (0.9, 0.999), eps 1e-8 added to √v̂, weight decay 0.01 on every leaf
  (optax's `mask=None`): `torch.optim.AdamW` with those arguments.
- **Loss.** `ctc_loss_from_logits` gives optax.ctc_loss's value and
  gradient on every row, then the batch mean. Rows whose labels fit in
  their frames (T ≥ L + the adjacent repeats, checked on the host from the
  lengths) go through `F.ctc_loss(reduction="none")`; optax gives a finite
  loss of about −log_epsilon = 1e5 to a row that cannot be aligned, where
  torch gives inf (and NaN gradients), so those rows run a plain-torch
  port of optax's recurrence (`optax_ctc_loss`).
- **Attention.** K5 has no backward. The step clears
  `use_flash_attention`, as the JAX step never sets it (its config
  default), so attention runs the plain or factorized path whatever
  WAV2VEC2_FLASH_FORCE says; `ops.flash_attention` raises on inputs that
  require grad besides.
- **Precision.** At f32 the whole step, the backward included, runs with
  TF32 off (`models.layers.full_f32_precision`), as the JAX f32 step runs
  at HIGHEST precision; at bf16 the flags are left alone.
- **No rematerialization.** The JAX package has no `jax.checkpoint` in its
  models, so the port adds no `torch.utils.checkpoint`.
- **Mesh.** As in the JAX package, placements are carried by the inputs:
  the params come from `parallel.mesh.shard_params` (tensor parallelism
  over 'model'), the batch is at `batch_sharding` (numpy or plain-tensor
  batches are distributed so by the step), and every rank calls the step
  with the same arguments (SPMD). The forward and backward run on
  DTensors; the CTC loss runs on each rank's rows (`mesh.batch_local`) and
  is the mean over the global batch. The gradients of replicated leaves
  are all-reduced over 'data', tensor-parallel leaves keep their shard's
  gradient, and AdamW updates every leaf in its placement.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Wav2Vec2ModelConfig
from ..models.ctc_model import frame_lengths, wav2vec2_forward
from ..models.layers import full_f32_precision, settle
from .mesh import batch_local, batch_sharding, distribute, is_dtensor

LOG_EPSILON = -1e5  # optax.ctc_loss's log(+0)


@dataclass
class TrainState:
    params: Any  # the tree of f32 leaves that require grad
    opt_state: torch.optim.Optimizer  # bound to those leaves
    step: int


def make_optimizer(
    learning_rate: float = 1e-4, weight_decay: float = 0.01
) -> Callable[..., torch.optim.Optimizer]:
    """`optax.adamw(learning_rate, weight_decay=weight_decay)`: a factory
    that `init_train_state` binds to the leaves."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a parameter tree, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _trainable(tree):
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_trainable(v) for v in tree]
    if not tree.is_floating_point():
        raise ValueError(f"a {tree.dtype} leaf cannot be trained (an int8-quantized tree?)")
    return tree.detach().to(torch.float32, copy=True).requires_grad_(True)


def init_train_state(params, tx: Callable[..., torch.optim.Optimizer]) -> TrainState:
    """A copy of `params` as f32 leaves that require grad (DTensor leaves
    stay DTensors in their placement), with the optimizer `tx` (from
    `make_optimizer`) bound to them."""
    params = _trainable(params)
    return TrainState(params=params, opt_state=tx(tree_leaves(params)), step=0)


class _LogAddExp(torch.autograd.Function):
    """`jnp.logaddexp` with JAX's own derivative, t1·exp(x1 − out) +
    t2·exp(x2 − out). On an infeasible row the terms sit near LOG_EPSILON =
    −1e5, where an f32 ulp is 0.0078, so a derivative evaluated in another
    form than JAX's moves the gradient by that much."""

    @staticmethod
    def forward(ctx, x1, x2):
        out = torch.maximum(x1, x2) + torch.log1p(torch.exp(-(x1 - x2).abs()))
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x1, x2, out = ctx.saved_tensors
        return grad * torch.exp(x1 - out), grad * torch.exp(x2 - out)


def optax_ctc_loss(log_probs: torch.Tensor, t_lens: torch.Tensor, labels: torch.Tensor,
                   label_lens: torch.Tensor, blank_id: int) -> torch.Tensor:
    """optax.ctc_loss_with_forward_probs' recurrence in plain torch: the
    per-row loss [B] of log-probs [B, T, V] against labels [B, L] (not
    blank-interleaved), with log(+0) taken as `LOG_EPSILON`, so a row whose
    labels cannot fit in its frames still gets a finite loss. Autograd
    differentiates it as JAX differentiates optax's scan."""
    b, t_pad, _ = log_probs.shape
    n = labels.shape[1]
    device = log_probs.device
    labels = labels.long()
    repeat = torch.zeros((b, n), dtype=torch.float32, device=device)
    if n > 1:
        repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).float()
    lp_phi = log_probs[:, :, blank_id]  # [B, T]
    lp_emit = torch.gather(log_probs, 2, labels[:, None, :].expand(b, t_pad, n))  # [B, T, N]
    pad = (torch.arange(t_pad, device=device)[None, :] >= t_lens[:, None]).float()

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], _LogAddExp.apply(phi[:, 1:], added)], dim=-1)

    phi = torch.full((b, n + 1), LOG_EPSILON, device=device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), LOG_EPSILON, device=device)
    for t in range(t_pad):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + LOG_EPSILON * repeat)
        e_t = lp_emit[:, t]
        next_emit = _LogAddExp.apply(prev_phi[:, :-1] + e_t, emit + e_t)
        p_t = lp_phi[:, t : t + 1]
        next_phi = update_phi(prev_phi + p_t, emit + p_t + LOG_EPSILON * (1.0 - repeat))
        m = pad[:, t : t + 1]
        emit = m * emit + (1.0 - m) * next_emit
        phi = m * prev_phi_orig + (1.0 - m) * next_phi
    phi_last = update_phi(phi, emit)
    return -phi_last.gather(1, label_lens.long()[:, None].to(device))[:, 0]


def ctc_feasible(t_lens, labels, label_lens) -> np.ndarray:
    """[B] bool on the host: the row's labels fit in its frames, T ≥ L plus
    the number of adjacent repeats (each needs a blank between)."""
    t_lens, labels, label_lens = (np.asarray(torch.as_tensor(a).cpu())
                                  for a in (t_lens, labels, label_lens))
    valid = np.arange(labels.shape[1])[None, 1:] < label_lens[:, None]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & valid).sum(axis=1)
    return t_lens >= label_lens + repeats


def _torch_ctc_loss(log_probs, t_lens, labels, label_lens, blank_id):
    """F.ctc_loss per row, for rows that can be aligned."""
    return F.ctc_loss(log_probs.transpose(0, 1), labels, t_lens, label_lens,
                      blank=blank_id, reduction="none")


def ctc_loss_from_logits(
    logits: torch.Tensor,
    t_lens: torch.Tensor,
    labels: torch.Tensor,
    label_lens: torch.Tensor,
    blank_id: int,
) -> torch.Tensor:
    """Mean CTC loss over the batch, as optax.ctc_loss gives it per row.
    logits [B, T, V] (any float dtype, taken in f32), labels [B, L] vocab
    ids (NOT blank-interleaved). On DTensors the rows are taken on each
    rank and the mean is over the global batch."""
    per_seq = batch_local(functools.partial(ctc_loss_per_row, blank_id=blank_id),
                          logits, t_lens, labels, label_lens)
    if is_dtensor(per_seq):
        return settle(per_seq.sum()) / per_seq.shape[0]
    # the batch mean, as the JAX step takes it (not torch's "mean", which
    # divides each row by its label length first)
    return per_seq.mean()


def ctc_loss_per_row(
    logits: torch.Tensor,
    t_lens: torch.Tensor,
    labels: torch.Tensor,
    label_lens: torch.Tensor,
    blank_id: int,
) -> torch.Tensor:
    """The CTC loss [B] of each row, as optax.ctc_loss gives it."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    device = log_probs.device
    t_lens, labels, label_lens = (torch.as_tensor(a, device=device).long()
                                  for a in (t_lens, labels, label_lens))
    feasible = ctc_feasible(t_lens, labels, label_lens)
    per_seq = log_probs.new_zeros(logits.shape[0])
    for rows, loss_fn in ((feasible, _torch_ctc_loss), (~feasible, optax_ctc_loss)):
        if rows.any():
            idx = torch.from_numpy(np.flatnonzero(rows)).to(device)
            per_seq = per_seq.index_put((idx,), loss_fn(
                log_probs[idx], t_lens[idx], labels[idx], label_lens[idx], blank_id))
    return per_seq


def make_train_step(
    model_cfg: Wav2Vec2ModelConfig,
    tx: Callable[..., torch.optim.Optimizer],
    mesh=None,
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """Returns step(state, audio, audio_lens, labels, label_lens) → (state,
    loss): one AdamW step on the batch, on the device the state's leaves
    live on. The inputs may be numpy arrays or tensors; `loss` is a 0-d f32
    tensor on that device (a replicated DTensor under `mesh`). `tx` is
    accepted for call-site symmetry with the JAX package: the optimizer is
    the one `init_train_state` bound. Under `mesh` the state's leaves are
    DTensors (`shard_params`, then `init_train_state`), and a batch that is
    not at `batch_sharding` yet is distributed so."""
    cfg = dataclasses.replace(model_cfg, use_flash_attention=False)
    blank_id = model_cfg.pad_token_id

    def step(state: TrainState, audio, audio_lens, labels, label_lens):
        device = tree_leaves(state.params)[0].device
        audio, audio_lens, labels, label_lens = (
            a if is_dtensor(a) else
            torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                            device=device)
            for a in (audio, audio_lens, labels, label_lens))
        if mesh is not None:
            audio, audio_lens, labels, label_lens = (
                a if is_dtensor(a) else distribute(a, mesh, batch_sharding(mesh))
                for a in (audio, audio_lens, labels, label_lens))
        state.opt_state.zero_grad(set_to_none=True)
        # the f32 backward's GEMMs and convolutions run without TF32 too:
        # the forward's own block ends before backward() runs
        precision = (full_f32_precision() if compute_dtype == torch.float32
                     else contextlib.nullcontext())
        with torch.enable_grad(), precision:
            logits = wav2vec2_forward(state.params, audio.float(), cfg,
                                      audio_lens=audio_lens, compute_dtype=compute_dtype)
            t_lens = frame_lengths(cfg, audio_lens)
            loss = ctc_loss_from_logits(logits, t_lens, labels, label_lens, blank_id)
            loss.backward()
        if mesh is not None:
            _reduce_grads(state.params)
        state.opt_state.step()
        return TrainState(state.params, state.opt_state, state.step + 1), loss.detach()

    return step


def _reduce_grads(params) -> None:
    """Each DTensor leaf's gradient at the leaf's own placement: a partial
    sum over 'data' (a replicated leaf's) is all-reduced, a tensor-parallel
    leaf keeps its shard's gradient."""
    for p in tree_leaves(params):
        if p.grad is not None and is_dtensor(p) and p.grad.placements != p.placements:
            p.grad = p.grad.redistribute(p.device_mesh, p.placements)
