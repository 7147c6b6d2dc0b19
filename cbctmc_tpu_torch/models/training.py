"""Training loops for the segmentation and speedup models.

The port of the JAX package's ``models/training.py`` (which replaces the
reference's external ``ipmi.deeplearning.BaseTrainer``: cbctmc/segmentation/
trainer.py, cbctmc/speedup/trainer.py). The trainers are functional, as the
JAX ones are: a :class:`TrainState` holds the parameters as a dict of
tensors by ``state_dict`` name, the net runs on them through
``torch.func.functional_call``, and :class:`Optimizer` computes what the JAX
trainers' ``optax.chain(clip_by_global_norm(grad_clip), adam(schedule))``
computes, as functions on tensors. :func:`flax_init` draws flax's
initialisation (``lecun_normal`` kernels, zero biases) from an explicit
``torch.Generator``. Batches come as the datasets make them (numpy,
channels last) and go to the trainer's one device channels first; over
several ranks, :func:`shard_batch` gives each rank its slice of a batch
(the JAX package's ``shard_batch`` over a mesh axis) and a train step on
the slices is the step of the whole batch: the gradients and the loss are
averaged over the axis's ranks before the clip. Checkpoints are flax's format (:func:`cbctmc_tpu_torch.models.
checkpoints.save_params`), the tree of the JAX model of the same
configuration.

A train step runs forward and backward with cuDNN's TF32 off: PyTorch
enables it by default, and a convolution's backward reads the flag when it
runs, after the forward's own span has closed.

The speedup schedule follows the reference's production recipe
(speedup/trainer.py:329-447): L1 pre-training of the mean head for
``n_pretrain_steps``, then Gaussian negative log likelihood training the
variance head; the step is a host integer, so the branch is chosen on the
host.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from cbctmc_tpu_torch import interop
from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.models.checkpoints import save_params
from cbctmc_tpu_torch.models.flex_unet import _float32_convolutions
from cbctmc_tpu_torch.models.losses import gaussian_nll_loss, l1_loss, segmentation_loss

logger = logging.getLogger(__name__)

Params = Dict[str, torch.Tensor]

# jax.nn.initializers.lecun_normal: a normal truncated at +-2 sigma, its
# stddev divided by that of the standard normal truncated there
_TRUNCATED_STD = 0.87962566103423978


class ShardedBatch(dict):
    """A rank's slice of a batch (:func:`shard_batch`), with the process
    group of the mesh axis it was cut along (``group``, of ``size`` ranks)."""

    def __init__(self, items, group, size: int):
        super().__init__(items)
        self.group, self.size = group, size


def shard_batch(batch: dict, mesh, axis_name: str = "photons") -> ShardedBatch:
    """This rank's slice along axis 0 of every array of ``batch`` (numpy or
    tensors, channels last as the datasets make them), on this rank's device
    (the mesh's: the CPU, or the current card), cut along the mesh axis
    ``axis_name`` as the JAX package's ``NamedSharding(mesh, P(axis_name))``
    cuts it: contiguous equal slices in the axis's rank order. A batch the
    axis's size does not divide is refused."""
    dim = mesh.mesh_dim_names.index(axis_name)
    size, rank = mesh.size(dim), mesh.get_local_rank(axis_name)
    dev = (torch.device("cpu") if mesh.device_type == "cpu"
           else torch.device(mesh.device_type, torch.cuda.current_device()))
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % size:
            raise ValueError(f"batch[{k!r}] of {n} rows does not divide over the "
                             f"{size} ranks of mesh axis {axis_name!r}")
        rows = v[rank * (n // size):(rank + 1) * (n // size)]
        out[k] = (rows if isinstance(rows, torch.Tensor) else
                  torch.from_numpy(np.ascontiguousarray(rows))).to(dev)
    return ShardedBatch(out, mesh.get_group(axis_name) if size > 1 else None, size)


def _mean_over(group, size: int, loss: torch.Tensor,
               grads: Params) -> Tuple[torch.Tensor, Params]:
    """The loss and the gradients averaged over the ``size`` ranks of
    ``group`` (one ``all_reduce`` of them all, flattened)."""
    import torch.distributed as dist

    names = list(grads)
    flat = torch.cat([loss.reshape(1)] + [grads[k].reshape(-1) for k in names])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat / torch.full_like(flat, float(size))
    out, at = {}, 1
    for k in names:
        n = grads[k].numel()
        out[k] = flat[at:at + n].view_as(grads[k])
        at += n
    return flat[0], out


def flax_init(model: nn.Module, generator: torch.Generator) -> Params:
    """``model``'s parameters drawn as flax initialises a ``nn.Conv``:
    kernels from ``lecun_normal`` (a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in, fan_in = in channels x kernel
    size), biases zero. Drawn on ``generator``'s device (the CPU's for a
    draw that does not depend on the card) in float32, as JAX draws its
    truncated normal: a uniform between erf(-2 / sqrt 2) and erf(2 / sqrt 2)
    through sqrt(2) erfinv."""
    params = {}
    dev = generator.device
    bound = torch.tensor(2.0 / math.sqrt(2.0), dtype=torch.float32)
    lo, hi = float(torch.erf(-bound)), float(torch.erf(bound))
    for name, value in model.state_dict().items():
        if name.endswith("bias"):
            params[name] = torch.zeros(value.shape, dtype=torch.float32)
            continue
        fan_in = int(np.prod(value.shape[1:]))
        u = torch.rand(value.shape, generator=generator, dtype=torch.float32, device=dev)
        x = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
        x = torch.clamp(x, math.nextafter(-2.0, 0.0), math.nextafter(2.0, 0.0))
        params[name] = (x * (math.sqrt(1.0 / fan_in) / _TRUNCATED_STD)).cpu()
    return params


def warmup_cosine_decay(learning_rate: float, total_steps: int) -> Callable[[int], np.float32]:
    """``optax.warmup_cosine_decay_schedule(init 0.1 lr, peak lr, warmup
    total // 20 (at least 1), decay total, end 0.02 lr)`` as the JAX
    trainers build it, evaluated in float32 as optax does."""
    f32 = np.float32
    init, peak, end = learning_rate * 0.1, learning_rate, learning_rate * 0.02
    warmup = max(1, total_steps // 20)
    decay = float(total_steps - warmup)
    if not decay > 0:
        raise ValueError(f"a schedule of {total_steps} steps has no decay after its warm-up")
    alpha = end / peak

    def schedule(count: int) -> np.float32:
        if count < warmup:
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return f32(init - peak) * frac + f32(peak)
        c = f32(min(float(count - warmup), decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
        return f32(peak) * (f32(1 - alpha) * cosine + f32(alpha))

    return schedule


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState`` (the schedule's count is the same
    count)."""

    count: int
    mu: Params
    nu: Params


class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adam(schedule))``:
    the global norm over every gradient; a gradient kept where the norm is
    below ``grad_clip``, else ``(g / norm) * grad_clip``; Adam with b1 0.9,
    b2 0.999, eps 1e-8 outside the square root, the bias corrections at the
    count after the update and the rate at the count before it."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float, grad_clip: float = 1.0,
                 total_steps: Optional[int] = None):
        self.grad_clip = grad_clip
        self.schedule = (warmup_cosine_decay(learning_rate, total_steps) if total_steps
                         else lambda count: np.float32(learning_rate))

    def init(self, params: Params) -> AdamState:
        return AdamState(count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
                         nu={k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState,
               params: Params) -> Tuple[Params, AdamState, torch.Tensor]:
        """The new parameters, the new state and the gradients' global norm
        (before clipping; a device scalar)."""
        some = next(iter(grads.values()))
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        trigger = g_norm < self.grad_clip
        count = state.count + 1
        f32 = np.float32

        def scalar(value):
            return torch.tensor(f32(value), dtype=torch.float32, device=some.device)

        bc1 = scalar(f32(1) - f32(self.b1) ** f32(count))
        bc2 = scalar(f32(1) - f32(self.b2) ** f32(count))
        step_size = scalar(-self.schedule(state.count))
        new_params, mu, nu = {}, {}, {}
        for name, g in grads.items():
            g = torch.where(trigger, g, (g / g_norm) * self.grad_clip)
            mu[name] = (1 - self.b1) * g + self.b1 * state.mu[name]
            nu[name] = (1 - self.b2) * (g * g) + self.b2 * state.nu[name]
            u = (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + self.eps)
            new_params[name] = params[name] + step_size * u
        return new_params, AdamState(count=count, mu=mu, nu=nu), g_norm


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: AdamState
    step: int = 0


class BaseTrainer:
    """``device``: ``cuda`` unless the caller passes ``"cpu"``."""

    def __init__(
        self,
        model: nn.Module,
        learning_rate: float = 1e-4,
        output_dir: Optional[Path] = None,
        checkpoint_every: int = 1000,
        log_every: int = 100,
        grad_clip: float = 1.0,
        total_steps: Optional[int] = None,
        device=None,
    ):
        """``grad_clip`` bounds the global gradient norm and
        ``total_steps`` enables a linear-warmup + cosine-decay schedule -
        both stabilisers the JAX package added after a speedup run diverged
        mid-L1-phase under constant-rate unclipped Adam."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = Optimizer(learning_rate, grad_clip, total_steps)
        self.output_dir = Path(output_dir) if output_dir else None
        self.checkpoint_every = checkpoint_every
        self.log_every = log_every

    def init(self, generator: torch.Generator, example_batch: dict) -> TrainState:
        """Fresh parameters (:func:`flax_init` on ``generator``) and optimizer
        state; ``example_batch`` must fit the net's input channels."""
        first = next(m for m in self.model.modules()
                     if isinstance(m, nn.modules.conv._ConvNd))
        channels = np.shape(example_batch["input"])[-1]
        if channels != first.in_channels:
            raise ValueError(f"a batch of {channels} input channels for a net of "
                             f"{first.in_channels}")
        params = {k: v.to(self.device) for k, v in flax_init(self.model, generator).items()}
        return TrainState(params=params, opt_state=self.optimizer.init(params))

    def to_device(self, batch: dict) -> Dict[str, torch.Tensor]:
        """A dataset's batch (numpy, channels last) as channels-first float32
        tensors on the trainer's device; a :class:`ShardedBatch` stays one."""
        if isinstance(batch, ShardedBatch):
            return ShardedBatch({k: v.to(self.device, torch.float32).movedim(-1, 1).contiguous()
                                 for k, v in batch.items()}, batch.group, batch.size)
        return {k: torch.from_numpy(np.ascontiguousarray(np.moveaxis(
                    np.asarray(v, np.float32), -1, 1))).to(self.device)
                for k, v in batch.items()}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.model, params, (x,))

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor], step: int):
        raise NotImplementedError

    def gradients(self, params: Params, batch: Dict[str, torch.Tensor],
                  step: int) -> Tuple[torch.Tensor, Params]:
        """The loss and its gradient by parameter (zeros where the loss does
        not depend on one), forward and backward with TF32 off."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with _float32_convolutions():
            loss = self.loss_fn(leaves, batch, step)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                               for (k, v), g in zip(leaves.items(), grads)}

    def _train_step(self, params: Params, opt_state: AdamState, batch, step: int):
        loss, grads = self.gradients(params, batch, step)
        if getattr(batch, "group", None) is not None:  # one rank's slice of the batch
            loss, grads = _mean_over(batch.group, batch.size, loss, grads)
        params, opt_state, _ = self.optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    def flax_tree(self, params: Params) -> dict:
        """The parameters as the JAX model's flax tree (numpy)."""
        return interop.flax_tree_from_state_dict(self.model, params)

    def trained_model(self, params: Params) -> nn.Module:
        """The trainer's net holding ``params`` (for inference)."""
        with torch.no_grad():
            for name, value in self.model.state_dict().items():
                value.copy_(params[name])
        return self.model

    def fit(
        self,
        state: TrainState,
        batches: Iterator[dict],
        n_steps: int,
        callback: Optional[Callable[[int, float], None]] = None,
    ) -> TrainState:
        for batch in batches:
            if state.step >= n_steps:
                break
            state.params, state.opt_state, loss = self._train_step(
                state.params, state.opt_state, self.to_device(batch), state.step)
            state.step += 1
            if state.step % self.log_every == 0:
                logger.info("step %d: loss=%.5f", state.step, float(loss))
            if callback:
                callback(state.step, float(loss))
            if self.output_dir and state.step % self.checkpoint_every == 0:
                save_params(self.flax_tree(state.params),
                            self.output_dir / f"step_{state.step}.ckpt")
        if self.output_dir:
            save_params(self.flax_tree(state.params), self.output_dir / "final.ckpt")
        return state


class SegmentationTrainer(BaseTrainer):
    """Dice training of the 9-label CT segmenter; batch dict keys:
    input [B, x, y, z, 1], target [B, x, y, z, 9] (one hot + vessels)."""

    def loss_fn(self, params, batch, step):
        return segmentation_loss(self.apply(params, batch["input"]), batch["target"])


class SpeedupTrainer(BaseTrainer):
    """Two-phase speedup training; batch dict keys:
    input [B, H, W, 2] (low photon, forward projection),
    target [B, H, W, 1] (high-photon projection)."""

    def __init__(self, model, n_pretrain_steps: int = 5000, **kwargs):
        super().__init__(model, **kwargs)
        self.n_pretrain_steps = n_pretrain_steps

    def loss_fn(self, params, batch, step):
        out = self.apply(params, batch["input"])
        mean, variance = out[:, 0:1], out[:, 1:2]
        if step < self.n_pretrain_steps:
            return l1_loss(mean, batch["target"])
        return gaussian_nll_loss(mean, variance, batch["target"])
