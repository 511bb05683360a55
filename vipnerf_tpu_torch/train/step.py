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
- Spans (`utils/tracing.py`): per sub-batch `train.forward` (the render),
  `train.losses` and `train.backward`, then `train.adam`; the forward and
  the backward also time their interval on the parameters' device.
- A `shard` (`parallel.mesh.StepShard`): the batch is this rank's part of
  the step, cut into the shard's sub-batches; before each, the generator (a
  `ShardGenerator`) is given this rank's rows of that global sub-batch, so
  it draws what one process draws. Where the shard's `group` shares the ray
  axis, each rank's losses are its shares of the global sub-batch's (global
  masked means, `LossComputer.compute_losses`), and one all_reduce (sum)
  per step of the flat gradient with those shares gives every rank the
  whole batch's gradient and loss scalars. Clipping then sees the reduced
  gradient, the loss guard the global loss, and Adam runs the same update
  on every rank, so the parameters stay identical across ranks. Where the
  scenes are sharded, the step needs no collective.

- On a CUDA device in one process (no `group`), the step is captured once
  as a CUDA graph and replayed (`GraphedStep`): the host launches one graph
  a step instead of the render's, the losses', autograd's and Adam's
  operations. Everything a step carries to the next (parameters, Adam's
  moments and count, the guard's state) is updated in place, on every
  path, so that the replays see it. Steps on the CPU and across ranks run
  eagerly.

The JAX package's TPU dispatch (`make_scan_train`, `make_host_loop_train`,
`default_step_dispatch`) has no counterpart; the CUDA graph plays the part
of its compiled step.
"""

from typing import Any, Callable, Dict, List, Optional

import torch

from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.train.guards import LossGuard
from vipnerf_tpu_torch.train.lr_schedules import get_lr_schedule
from vipnerf_tpu_torch.utils import tracing

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
        # the state is written in place: a replayed CUDA graph writes where it captured
        if self.guard is None:
            self.exp_avg.copy_(m)
            self.exp_avg_sq.copy_(v)
            self.count.add_(1)
        else:
            accept = self.guard(loss)
            keep = accept[:, None]
            update = torch.where(keep, update, 0.0)
            self.exp_avg.copy_(torch.where(keep, m, self.exp_avg))
            self.exp_avg_sq.copy_(torch.where(keep, v, self.exp_avg_sq))
            self.count.add_(accept.int())
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


def all_reduce_grads(params: List[torch.Tensor], scalars: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Sum every parameter's gradient and the loss scalars over the ranks,
    in one all_reduce of a flat buffer; the gradients are written back."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    names = list(scalars)
    flat = torch.cat([g.reshape(-1) for g in grads] + [scalars[k].reshape(1) for k in names])
    group.all_reduce_sum(flat)
    sizes = [g.numel() for g in grads]
    pieces = flat.split(sizes + [1] * len(names))
    for p, g, piece in zip(params, grads, pieces):
        p.grad = piece.view_as(g)
    return {k: piece.reshape(()) for k, piece in zip(names, pieces[len(grads):])}


class StepGraph:
    """The CUDA graph of a training step on `device`: `warm` runs the step
    eagerly on a side stream (torch's warm-up before a capture), `capture`
    captures it on that stream with the step's generator registered (each
    replay then draws from the generator's seed and offset at its launch,
    as the eager step draws), `replay` launches it on the current stream.
    A capture that fails raises."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graph = None

    def warm(self, fn: Callable):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def capture(self, fn: Callable, generator) -> torch.Tensor:
        self.graph = None  # the old graph's memory goes back first
        graph = torch.cuda.CUDAGraph()
        if generator is not None:  # its state, which a subclass (`ShardGenerator`) shares
            graph.register_generator_state(generator.graphsafe_get_state())
        with torch.cuda.graph(graph, stream=self.stream):
            out = fn()
        self.graph = graph
        return out

    def replay(self) -> None:
        self.graph.replay()


class GraphedStep:
    """A training step on a CUDA device in one process, replayed as one CUDA
    graph: the host launches the graph instead of the step's hundreds of
    operations. The kernels and their order are the eager step's.

    The first call runs `step` eagerly (the warm-up); the next one captures
    it and replays the capture to run itself; every later call copies its
    batch into the graph's inputs and replays. A call re-captures where the
    graph would replay something else than the eager step would run: a
    change of the staged loss weights (`LossComputer.get_loss_weight` at the
    batch's `iter_num`, the only use of the iteration in a step), of the
    batch's keys, shapes or dtypes (or its other non-tensor values), of the
    generator, or of the data pointer of any parameter or optimizer state
    (a state replaced instead of written in place). Each call returns its
    own loss scalars, copied out of the graph's outputs.

    Around the graph: the generator is seeded by the caller before each
    call, as for an eager step; the parameters' `_version`s are bumped after
    each replay (which writes them in place unseen by autograd's counters),
    so that a cache keyed on them, K1's packed weights, packs again for an
    eager use; the tracer records the capture's counts and device-timed
    spans and adds them again per replay (`utils/tracing.py`), counts
    `train.graph.captures` and `train.graph.replays`, and marks the
    replayed step's span `graph=True`.

    `graph` is a `StepGraph`, or a stand-in with its methods (tests)."""

    def __init__(self, step: Callable, optimizer: Adam, loss_computer: LossComputer, graph,
                 device: torch.device):
        self.eager = step
        self.optimizer, self.loss_computer, self.graph, self.device = optimizer, loss_computer, graph, device
        self.warm = False
        self.key = None
        self.inputs: Dict[str, Any] = {}  # the batch the graph reads
        self.outputs = None  # the loss scalars the graph writes, flat
        self.layout: List[tuple] = []  # (name, shape, dtype, start, stop) of each scalar in `outputs`
        self.recording = None

    def state(self) -> List[torch.Tensor]:
        """Every tensor the step carries to the next: parameters, Adam's
        moments and count, the loss guard's state."""
        opt = self.optimizer
        guard = [] if opt.guard is None else [opt.guard.ema, opt.guard.count, opt.guard.skips]
        return list(opt.params) + [opt.exp_avg, opt.exp_avg_sq, opt.count] + guard

    def signature(self, batch: Dict[str, Any], generator) -> tuple:
        """What the graph bakes in, of a call: see the class docstring."""
        it = int(batch["iter_num"])
        weights = tuple(self.loss_computer.get_loss_weight(name, it) for name in self.loss_computer.losses)
        layout = tuple((k, tuple(v.shape), v.dtype, v.device) if torch.is_tensor(v) else (k, v)
                       for k, v in sorted(batch.items()) if k != "iter_num")
        return weights, layout, id(generator), tuple(t.data_ptr() for t in self.state())

    def __call__(self, model, batch: Dict[str, Any], generator) -> Dict[str, torch.Tensor]:
        if not self.warm:
            self.warm = True
            return self.graph.warm(lambda: self.eager(model, batch, generator))
        key = self.signature(batch, generator)
        if key != self.key:
            self._capture(model, batch, generator)
            self.key = key
        else:
            for k, v in batch.items():
                if torch.is_tensor(v) and v is not self.inputs[k]:
                    self.inputs[k].copy_(v)
        with tracing.replay(self.recording):
            self.graph.replay()
        tracing.count("train.graph.replays")
        tracing.annotate(graph=True)
        self._bump_versions()
        flat = self.outputs.clone()
        return {name: flat[a:b].view(shape).to(dtype) for name, shape, dtype, a, b in self.layout}

    def _bump_versions(self) -> None:
        for p in self.optimizer.params:
            torch.autograd.graph.increment_version(p)

    def _capture(self, model, batch: Dict[str, Any], generator) -> None:
        self.key = self.recording = self.outputs = None
        # the graph's own copy of the batch: later calls copy theirs in, never into the caller's tensors
        self.inputs = {k: v.clone() if torch.is_tensor(v) else v for k, v in batch.items()}
        self.optimizer.zero_grad()  # the last step's gradients are freed before the capture
        self._bump_versions()  # a pack cached by an eager use is packed again inside the graph
        recording = tracing.Recording(self.device)  # outside the graph: its row counter is not the graph's
        layout = []

        def step():
            with tracing.capture(recording):
                scalars = self.eager(model, self.inputs, generator)
                sizes = [v.numel() for v in scalars.values()]
                ends = [sum(sizes[:i + 1]) for i in range(len(sizes))]
                layout[:] = [(name, tuple(v.shape), v.dtype, end - size, end)
                             for (name, v), size, end in zip(scalars.items(), sizes, ends)]
                return torch.cat([v.reshape(-1).float() for v in scalars.values()])

        self.outputs = self.graph.capture(step, generator)
        self.recording, self.layout = recording, layout
        tracing.count("train.graph.captures")


def make_train_step(
    configs: Dict[str, Any],
    render_fn: Callable,
    loss_computer: LossComputer,
    optimizer: Adam,
    shard=None,
) -> Callable:
    """train_step(model, batch, generator) -> {loss name: device tensor},
    after one optimizer step; a stacked model's losses are per scene, (S,),
    and backward runs on their sum, which gives each scene its own gradient
    (the scenes share no parameter). With a `shard`, `batch` is this rank's
    part of the step (see the module docstring).

    With the parameters on a CUDA device and no `group` in the shard (no
    collective in the step), the step is a `GraphedStep`: replayed as one
    CUDA graph from its second call on. Elsewhere (the CPU, ranks that share
    the ray axis) it runs eagerly. Either way `train_step.eager` is the
    eager step."""
    sub_batch_size = configs.get("sub_batch_size") if shard is None else shard.sub_batch_size
    group = None if shard is None else shard.group
    device = optimizer.params[0].device

    def loss_and_backward(model, batch, generator):
        with tracing.span("train.forward", device):
            outputs = render_fn(model, configs, batch, train=True, generator=generator)
        with tracing.span("train.losses"):
            if model.scenes is None:
                losses = loss_computer.compute_losses(batch, outputs, group=group)
            else:
                losses = loss_computer.scene_losses(batch, outputs, model.scenes)
        with tracing.span("train.backward", device):
            losses["TotalLoss"].sum().backward()
        return {k: (v["loss_value"] if isinstance(v, dict) else v).detach()
                for k, v in losses.items()}

    def train_step(model, batch, generator):
        optimizer.zero_grad()
        subs = [batch] if sub_batch_size is None else _sub_batches(batch, sub_batch_size, model.scenes)
        scalars = None
        for i, sub in enumerate(subs):
            if shard is not None and generator is not None:
                generator.shard(*shard.draws[i])
            part = loss_and_backward(model, sub, generator)
            scalars = part if scalars is None else {k: scalars[k] + part[k] for k in part}
        if group is not None:
            scalars = all_reduce_grads(optimizer.params, scalars, group)
        with tracing.span("train.adam"):
            optimizer.step(loss=scalars["TotalLoss"])
        return scalars

    if device.type == "cuda" and group is None:
        return GraphedStep(train_step, optimizer, loss_computer, StepGraph(device), device)
    train_step.eager = train_step
    return train_step
