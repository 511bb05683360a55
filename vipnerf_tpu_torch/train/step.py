"""One training iteration: render -> losses -> backward -> Adam (counterpart
of vipnerf_tpu/train/step.py `make_optimizer` and `make_train_step`, and of
vipnerf_tpu/train/guards.py `loss_guard`).

- `Adam`: optax's adam, (m/(1-b1^t)) / (sqrt(v/(1-b2^t)) + eps) with eps
  1e-8, update `it` (the count of earlier updates, saved and restored with
  the state) at `schedule(it)`. The moments and the count live on the
  device, so a step reads nothing back to the host: the learning rate is
  computed there from the count.
- Scenes: for a stacked model (S scenes, every parameter with a leading
  scene axis) the moments are (S, P) and the count (S,): per-scene Adam, as
  `vmap` of optax over stacked params. Without a guard the counts move in
  lockstep.
- Optional `optimizer.grad_clip_norm`: each scene's gradients are scaled to
  that global norm when it is exceeded, before Adam (optax
  clip_by_global_norm, per scene as `vmap` of it gives: a norm over the
  stacked tensors would couple the scenes).
- Optional `optimizer.loss_guard` (`train/guards.py` `LossGuard`): a
  step whose loss exceeds `factor` x the EMA of accepted losses is
  rejected: its update is zero and Adam's moments and count are held, so
  the schedule reads the count of accepted updates. One guard per scene;
  the decision is made on the device.
- `sub_batch_size`: each scene's rays are cut into equal sub-batches whose
  gradients are summed before one step; the loss scalars are summed too.
- The loss scalars stay on the device, (S,) per name for a stacked model:
  the caller reads them when it needs them, not every step.

The JAX package's TPU dispatch (`make_scan_train`, `make_host_loop_train`,
`default_step_dispatch`) has no counterpart: PyTorch runs eagerly.
"""

from typing import Any, Callable, Dict, List, Optional

import torch

from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.train.guards import LossGuard
from vipnerf_tpu_torch.train.lr_schedules import get_lr_schedule

EPS = 1e-8


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale `grads` in place to global norm `max_norm` when it is exceeded."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = (max_norm / norm).clamp(max=1.0)
    for g in grads:
        g.mul_(scale)


class Adam:
    """optax's Adam (with the optional clipping and loss guard) over a
    model's parameters; with `scenes`, per scene over a stacked model's.

    `state_dict(scene)` / `load_state_dict(state, scene)` read and write one
    scene's state in torch.optim.Adam's layout (`state[i]` with `step`,
    `exp_avg`, `exp_avg_sq`; `param_groups`), the reference checkpoints'
    layout, plus the guard's state under `loss_guard`."""

    def __init__(self, configs: Dict[str, Any], params, scenes: Optional[int] = None):
        opt = configs["optimizer"]
        self.params = list(params)
        self.scenes = scenes
        self.b1, self.b2 = opt.get("beta1", 0.9), opt.get("beta2", 0.999)
        self.schedule = get_lr_schedule(configs)
        self.clip = opt.get("grad_clip_norm")
        rows = scenes or 1
        device = self.params[0].device
        self.shapes = [p.shape[1:] if scenes else p.shape for p in self.params]
        self.sizes = [s.numel() for s in self.shapes]
        self.exp_avg = torch.zeros((rows, sum(self.sizes)), device=device)
        self.exp_avg_sq = torch.zeros_like(self.exp_avg)
        self.count = torch.zeros(rows, dtype=torch.int32, device=device)
        guard = opt.get("loss_guard")
        self.guard = None if guard is None else LossGuard(rows, device, **guard)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, loss: Optional[torch.Tensor] = None):
        """One update from the parameters' gradients; `loss` ((S,) or ())
        feeds the guard."""
        rows = self.exp_avg.shape[0]
        g = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(rows, -1)
                       for p in self.params], dim=1)
        if self.clip:
            for row in g:  # each scene to its own global norm
                clip_by_global_norm([row], float(self.clip))
        m = self.b1 * self.exp_avg + (1.0 - self.b1) * g
        v = self.b2 * self.exp_avg_sq + (1.0 - self.b2) * g * g
        t = (self.count + 1).float()
        lr = self.schedule(self.count.float())
        update = m / (1.0 - self.b1 ** t)[:, None]
        update = update / (torch.sqrt(v / (1.0 - self.b2 ** t)[:, None]) + EPS) * -lr[:, None]
        if self.guard is None:
            self.exp_avg, self.exp_avg_sq, self.count = m, v, self.count + 1
        else:
            accept = self.guard(loss)
            keep = accept[:, None]
            update = torch.where(keep, update, 0.0)
            self.exp_avg = torch.where(keep, m, self.exp_avg)
            self.exp_avg_sq = torch.where(keep, v, self.exp_avg_sq)
            self.count = self.count + accept.int()
        pieces = update.split(self.sizes, dim=1)
        torch._foreach_add_(self.params, [u.reshape(p.shape) for u, p in zip(pieces, self.params)])

    def state_dict(self, scene: Optional[int] = None) -> Dict[str, Any]:
        row = scene or 0
        count = int(self.count[row])
        m = self.exp_avg[row].split(self.sizes)
        v = self.exp_avg_sq[row].split(self.sizes)
        state = {i: {"step": torch.tensor(float(count)), "exp_avg": a.reshape(s).cpu().clone(),
                     "exp_avg_sq": b.reshape(s).cpu().clone()}
                 for i, (a, b, s) in enumerate(zip(m, v, self.shapes))}
        group = {"lr": float(self.schedule(count)), "betas": (self.b1, self.b2), "eps": EPS,
                 "weight_decay": 0.0, "amsgrad": False, "params": list(range(len(self.params)))}
        out = {"state": state, "param_groups": [group]}
        if self.guard is not None:
            out["loss_guard"] = self.guard.state(row)
        return out

    @torch.no_grad()
    def load_state_dict(self, state_dict: Dict[str, Any], scene: Optional[int] = None,
                        iteration_num: Optional[int] = None):
        """Load one scene's state, as the JAX package's migration of a
        reference checkpoint reads it (vipnerf_tpu/utils/reference_ckpt.py
        `convert_adam_moments`, `convert_checkpoint`): `state` is indexed by
        parameter position, as an integer or a string; a parameter with no
        entry gets zero moments; the count is the largest `step` of the
        entries, or `iteration_num` when there is none."""
        row = scene or 0
        state = state_dict.get("state") or {}
        device = self.exp_avg.device
        m, v, count = [], [], 0
        for i, shape in enumerate(self.shapes):
            entry = state.get(i, state.get(str(i)))
            if entry is None:
                m.append(torch.zeros(shape.numel(), device=device))
                v.append(torch.zeros(shape.numel(), device=device))
                continue
            for key, out in (("exp_avg", m), ("exp_avg_sq", v)):
                moment = torch.as_tensor(entry[key], dtype=torch.float32, device=device)
                if moment.shape != shape:
                    raise ValueError(f"optimizer state {i}: {key} of shape {tuple(moment.shape)}, "
                                     f"parameter of shape {tuple(shape)}")
                out.append(moment.reshape(-1))
            count = max(count, int(entry["step"]))
        if not count and iteration_num is not None:
            count = iteration_num
        self.exp_avg[row] = torch.cat(m)
        self.exp_avg_sq[row] = torch.cat(v)
        self.count[row] = count
        if self.guard is not None and "loss_guard" in state_dict:
            self.guard.load(row, state_dict["loss_guard"])


def make_optimizer(configs: Dict[str, Any], params, scenes: Optional[int] = None) -> Adam:
    return Adam(configs, params, scenes)


def _sub_batches(batch: Dict[str, Any], size: int, scenes: Optional[int]):
    """Sub-batches of `size` rays of each scene (S * size rays, scene-major)."""
    nr = batch["rays_o"].shape[0]
    rows = scenes or 1
    per_scene = nr // rows
    if per_scene % size:
        raise ValueError(f"sub_batch_size {size} does not divide the batch of {per_scene} rays per scene")
    ray_keys = {k for k, v in batch.items()
                if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == nr}
    for i in range(per_scene // size):
        sub = {}
        for k, v in batch.items():
            if k in ray_keys:
                v = v.reshape(rows, per_scene, *v.shape[1:])[:, i * size:(i + 1) * size]
                v = v.reshape(rows * size, *v.shape[2:])
            sub[k] = v
        yield sub


def make_train_step(
    configs: Dict[str, Any],
    render_fn: Callable,
    loss_computer: LossComputer,
    optimizer: Adam,
) -> Callable:
    """train_step(model, batch, generator) -> {loss name: device tensor},
    after one optimizer step; a stacked model's losses are per scene, (S,),
    and backward runs on their sum, which gives each scene its own gradient
    (the scenes share no parameter)."""
    sub_batch_size = configs.get("sub_batch_size")

    def loss_and_backward(model, batch, generator):
        outputs = render_fn(model, configs, batch, train=True, generator=generator)
        if model.scenes is None:
            losses = loss_computer.compute_losses(batch, outputs)
        else:
            losses = loss_computer.scene_losses(batch, outputs, model.scenes)
        losses["TotalLoss"].sum().backward()
        return {k: (v["loss_value"] if isinstance(v, dict) else v).detach()
                for k, v in losses.items()}

    def train_step(model, batch, generator):
        optimizer.zero_grad()
        if sub_batch_size is None:
            scalars = loss_and_backward(model, batch, generator)
        else:
            scalars = None
            for sub in _sub_batches(batch, sub_batch_size, model.scenes):
                part = loss_and_backward(model, sub, generator)
                scalars = part if scalars is None else {k: scalars[k] + part[k] for k in part}
        optimizer.step(loss=scalars["TotalLoss"])
        return scalars

    return train_step
