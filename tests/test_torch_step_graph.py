"""The training step replayed as a CUDA graph (`train/step.py` `GraphedStep`)
and what it needs, on the CPU:

- the CPU step stays eager, and its Adam (now writing its state in place)
  is the old functional arithmetic bit for bit over several steps, with
  clipping and the loss guard;
- the graph's plumbing with a stand-in graph that runs the step at each
  replay on the state the capture saw: the graphed steps equal the eager
  ones bit for bit, and a re-capture follows a change of the staged loss
  weights, of the batch's shapes, or of a state tensor, and nothing else;
- the tracer's replay bookkeeping on made-up stamps and counter deltas.

The card's own graph is held to the eager step in
`tests/test_torch_kernels_cuda.py` (marker `cuda`)."""

import pytest
import torch

from tests.test_torch_losses import narrow_configs, step_batch, torch_tree
from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.models import vip_nerf
from vipnerf_tpu_torch.train.step import EPS, Adam, GraphedStep, make_optimizer, make_train_step
from vipnerf_tpu_torch.utils import tracing

STEPS = 5


class FunctionalAdam(Adam):
    """The optimizer's step as it was before it wrote its state in place:
    every state tensor rebound to a new one each step."""

    @torch.no_grad()
    def step(self, loss=None):
        from vipnerf_tpu_torch.train.step import clip_by_global_norm

        rows = self.exp_avg.shape[0]
        g = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(rows, -1)
                       for p in self.params], dim=1)
        if self.clip:
            for row in g:
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
            guard = self.guard
            loss = loss.detach().float().reshape(guard.ema.shape)
            first = guard.count == 0
            accept = (first | (guard.count < guard.warmup) | (guard.skips >= guard.max_consecutive_skips)
                      | (loss <= guard.factor * guard.ema))
            ema_next = torch.where(first, loss, guard.ema_decay * guard.ema + (1.0 - guard.ema_decay) * loss)
            guard.ema = torch.where(accept, ema_next, guard.ema)
            guard.skips = torch.where(accept, 0, guard.skips + 1).int()
            guard.count = guard.count + 1
            keep = accept[:, None]
            update = torch.where(keep, update, 0.0)
            self.exp_avg = torch.where(keep, m, self.exp_avg)
            self.exp_avg_sq = torch.where(keep, v, self.exp_avg_sq)
            self.count = self.count + accept.int()
        pieces = update.split(self.sizes, dim=1)
        torch._foreach_add_(self.params, [u.reshape(p.shape) for u, p in zip(pieces, self.params)])


CASES = {
    "plain": {},
    "grad_clip_norm": {"grad_clip_norm": 0.05},
    # a warm-up of 2, then a factor under 1 rejects every step that does not fall far
    "loss_guard": {"loss_guard": {"factor": 0.5, "ema_decay": 0.5, "warmup": 2, "max_consecutive_skips": 1}},
}


def configs(optimizer=None, stage=None):
    """The narrow model with perturbed samples and sigma noise (the step
    draws from its generator), a prior loss staged at `stage`."""
    cfg = narrow_configs()
    cfg["model"].update(perturb=True, raw_noise_std=1.0)
    cfg["optimizer"].update(optimizer or {})
    if stage is not None:
        cfg["losses"][2]["iter_weights"] = {"0": 0.001, str(stage): 0.01}
    return cfg


def model_of(cfg):
    torch.manual_seed(0)
    return vip_nerf.ViPNeRF(cfg)


def state_of(model, opt):
    guard = [] if opt.guard is None else [opt.guard.ema, opt.guard.count, opt.guard.skips]
    return [p.detach().clone() for p in model.parameters()] + [
        t.clone() for t in [opt.exp_avg, opt.exp_avg_sq, opt.count] + guard]


def run_steps(cfg, opt_cls, step_of=None, batches=None):
    """STEPS steps from the seeded model; the losses of each and the state after."""
    model = model_of(cfg)
    opt = opt_cls(cfg, model.parameters())
    step = make_train_step(cfg, vip_nerf.render_rays, LossComputer(cfg), opt)
    if step_of is not None:
        step = step_of(step, opt, cfg)
    gen = torch.Generator()
    losses = []
    for it, b in enumerate(batches or [step_batch(it) for it in range(STEPS)]):
        gen.manual_seed(1000 + it)
        losses.append({k: v.clone() for k, v in step(model, torch_tree(b), gen).items()})
    return losses, state_of(model, opt), step


def assert_equal_runs(a, b):
    (losses_a, state_a), (losses_b, state_b) = a, b
    assert len(losses_a) == len(losses_b)
    for la, lb in zip(losses_a, losses_b):
        assert la.keys() == lb.keys()
        for k in la:
            assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
            assert torch.equal(la[k], lb[k]), (k, la[k], lb[k])
    for x, y in zip(state_a, state_b, strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_step_is_eager_and_its_adam_is_the_functional_arithmetic(case):
    cfg = configs(CASES[case])
    new_losses, new_state, step = run_steps(cfg, Adam)
    old_losses, old_state, _ = run_steps(cfg, FunctionalAdam)
    assert not isinstance(step, GraphedStep) and step.eager is step
    assert_equal_runs((new_losses, new_state), (old_losses, old_state))
    if case == "loss_guard":  # the guard rejected some steps and accepted others
        count = int(new_state[-4])  # Adam's count: the accepted steps
        assert 0 < count < STEPS


class StandInGraph:
    """`StepGraph`'s methods on the CPU: `capture` runs the step once to make
    its outputs and puts the state (and the generator) back as it found
    them, as a capture leaves them; `replay` runs the step again on the
    captured inputs and writes its outputs where the capture's are."""

    def __init__(self):
        self.captures = self.replays = 0
        self.graphed = None

    def warm(self, fn):
        return fn()

    def capture(self, fn, generator):
        self.captures += 1
        saved = [t.clone() for t in self.graphed.state()]
        rng = generator.get_state()
        out = fn()
        with torch.no_grad():
            for t, s in zip(self.graphed.state(), saved):
                t.copy_(s)
        generator.set_state(rng)
        self.fn, self.out = fn, out
        return out

    def replay(self):
        self.replays += 1
        rec = self.graphed.recording  # what the capture recorded stays as it was
        kept = (list(rec.spans), dict(rec.counts), rec.slots)
        self.out.copy_(self.fn())
        rec.spans, rec.counts, rec.slots = kept


def graphed(step, opt, cfg):
    graph = StandInGraph()
    out = GraphedStep(step.eager, opt, LossComputer(cfg), graph, torch.device("cpu"))
    graph.graphed = out
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_steps_equal_the_eager_steps(case):
    """One warm-up, one capture, then replays: the losses each step returns,
    the parameters, Adam's moments and count, the guard's state and the
    generator's draws (perturbation and sigma noise) are the eager run's."""
    cfg = configs(CASES[case])
    eager = run_steps(cfg, Adam)[:2]
    losses, state, step = run_steps(cfg, Adam, graphed)
    assert step.graph.captures == 1 and step.graph.replays == STEPS - 1
    assert_equal_runs((losses, state), eager)


def test_each_replay_returns_its_own_losses():
    cfg = configs()
    losses, _, step = run_steps(cfg, Adam, graphed)
    totals = [float(s["TotalLoss"]) for s in losses]
    assert len(set(totals)) == STEPS  # not the last step's values, shared
    assert losses[-1]["TotalLoss"].data_ptr() != losses[-2]["TotalLoss"].data_ptr()


def test_recapture_keys_on_the_loss_stage_the_shapes_and_replaced_state():
    """Re-captures at the loss stage's iteration, at a batch of another size
    and after Adam's moments are replaced by a copy; replays otherwise. The
    tracer counts both."""
    stage = 4
    cfg = configs(stage=stage)
    model = model_of(cfg)
    opt = make_optimizer(cfg, model.parameters())
    step = graphed(make_train_step(cfg, vip_nerf.render_rays, LossComputer(cfg), opt), opt, cfg)
    gen = torch.Generator()
    before = tracing.counts("train.graph.")
    seen = []

    def run(it, nr=32):
        gen.manual_seed(it)
        step(model, torch_tree(step_batch(it, nr=nr)), gen)
        seen.append((step.graph.captures, step.graph.replays))

    for it in range(stage + 2):  # warm-up, capture at 1, replays, the stage's weights at 4: a capture
        run(it)
    assert seen == [(0, 0), (1, 1), (1, 2), (1, 3), (2, 4), (2, 5)]
    run(6, nr=16)  # another batch size
    run(7, nr=16)
    assert seen[-2:] == [(3, 6), (3, 7)]
    opt.exp_avg = opt.exp_avg.clone()  # a state tensor replaced
    run(8, nr=16)
    run(9, nr=16)
    assert seen[-2:] == [(4, 8), (4, 9)]
    other = torch.Generator()
    other.manual_seed(10)
    step(model, torch_tree(step_batch(10, nr=16)), other)  # another generator
    assert (step.graph.captures, step.graph.replays) == (5, 10)
    after = tracing.counts("train.graph.")
    assert {k: after.get(k, 0) - before.get(k, 0) for k in ("train.graph.captures", "train.graph.replays")} == {
        "train.graph.captures": 5, "train.graph.replays": 10}


def test_a_replay_bumps_the_parameters_versions():
    """A replay writes the parameters unseen by their version counters: the
    step bumps them, so K1's pack cache (keyed on them) packs again for an
    eager use."""
    cfg = configs()
    model = model_of(cfg)
    opt = make_optimizer(cfg, model.parameters())
    step = graphed(make_train_step(cfg, vip_nerf.render_rays, LossComputer(cfg), opt), opt, cfg)
    gen = torch.Generator()
    for it in range(3):
        gen.manual_seed(it)
        step(model, torch_tree(step_batch(it)), gen)
    versions = [p._version for p in model.parameters()]
    step.graph.fn = lambda: step.outputs  # a replay that writes nothing autograd sees, as the card's
    step(model, torch_tree(step_batch(3)), gen)
    assert all(p._version > v for p, v in zip(model.parameters(), versions))


# ------------------------------------------------------------------ the tracer


def captured_step(t, dev):
    """What a capture of one step records on tracer `t`."""
    with t.capture(tracing.Recording(dev)) as rec:
        with t.span("train.forward", dev):
            with t.span("rays.coarse.sec_dirs", dev):
                t.count("vis.sec_view_points", 10)
            t.count("k1.launches.fused_mlp_bf16_f32h", 2)
        with t.span("train.losses"):
            pass
        with t.span("train.backward", dev):
            pass
        with t.span("train.adam"):
            pass
    return rec


def test_a_capture_keeps_nothing_and_records_its_template():
    t = tracing.Tracer()
    dev = torch.device("cpu")
    rec = captured_step(t, dev)
    assert t.snapshot() == {"spans": [], "counts": {}}
    assert [s[0] for s in rec.spans] == ["rays.coarse.sec_dirs", "train.forward", "train.backward"]
    assert rec.counts == {"vis.sec_view_points": 10, "k1.launches.fused_mlp_bf16_f32h": 2}
    assert rec.slots == 6
    with pytest.raises(RuntimeError, match="already"):
        with t.capture(tracing.Recording(dev)):
            with t.capture(tracing.Recording(dev)):
                pass
    with t.span("after"):  # the tracer records again after a capture, also one that failed
        t.count("c")
    assert t.counts() == {"c": 1} and [s["name"] for s in t.snapshot()["spans"]] == ["after"]


def stamp(rec, it, row):
    """Made-up stamps of step `it`: forward [10, 13 + it] ms from the step's
    start, its sec_dirs [11, 12], backward [13 + it, 20 + 2 it]."""
    base = 1_000_000_000 + it * 100_000_000
    ms = {"train.forward": (10, 13 + it), "rays.coarse.sec_dirs": (11, 12), "train.backward": (13 + it, 20 + 2 * it)}
    for name, _, _, _, start, end in rec.spans:
        rec.stamps[row, start] = base + ms[name][0] * 1_000_000
        rec.stamps[row, end] = base + ms[name][1] * 1_000_000


@pytest.mark.parametrize("rows", [tracing.STAMP_ROWS, 2])
def test_replays_land_under_their_steps_and_repeat_the_counts(monkeypatch, rows):
    """Each replay adds the recorded counts again and the recorded spans
    under the open `train.step`, with device_ms from its own row of stamps
    (also where the rows wrap before a read: 2 rows for 5 replays); the
    step span carries `graph`."""
    monkeypatch.setattr(tracing, "STAMP_ROWS", rows)
    t = tracing.Tracer()
    dev = torch.device("cpu")
    rec = captured_step(t, dev)
    for it in range(5):
        with t.span("train.step", it=it):
            row = rec.replays % rows
            with t.replay(rec):
                stamp(rec, it, row)  # the graph writes its row while it runs
            t.annotate(graph=True)
    snap = t.snapshot()
    assert snap["counts"] == {"vis.sec_view_points": 50, "k1.launches.fused_mlp_bf16_f32h": 10}
    spans = snap["spans"]
    steps = [s for s in spans if s["name"] == "train.step"]
    assert [s["attrs"] for s in steps] == [{"it": it, "graph": True} for it in range(5)]
    for it, step in enumerate(steps):
        kids = {s["name"]: s for s in spans if s["parent"] == step["id"]}
        assert sorted(kids) == ["train.backward", "train.forward"]
        fwd, bwd = kids["train.forward"], kids["train.backward"]
        (sec,) = [s for s in spans if s["parent"] == fwd["id"]]
        assert sec["name"] == "rays.coarse.sec_dirs"
        for span, want in ((fwd, 3 + it), (bwd, 7 + it), (sec, 1)):
            assert span["device_ms"][1] - span["device_ms"][0] == pytest.approx(want)
            assert step["start_ns"] <= span["start_ns"] <= span["end_ns"] <= step["end_ns"]


def test_a_root_of_another_thread_joins_the_replaying_step():
    """A device span opened in autograd's device thread during the capture
    (K1's trunk backward) has no parent there: each replay puts it under its
    step, where the readers look for it."""
    import threading

    t = tracing.Tracer()
    dev = torch.device("cpu")
    with t.capture(tracing.Recording(dev)) as rec:
        with t.span("train.backward", dev):
            worker = threading.Thread(target=lambda: t.span("k1.trunk_backward", dev, part="layers").__enter__()
                                      .__exit__(None, None, None))
            worker.start()
            worker.join()
    assert [s[0] for s in rec.spans] == ["k1.trunk_backward", "train.backward"]
    with t.span("train.step", it=0) as step:
        with t.replay(rec):
            pass
    spans = {s["name"]: s for s in t.snapshot()["spans"]}
    assert spans["k1.trunk_backward"]["parent"] == step.id == spans["train.backward"]["parent"]
    assert spans["k1.trunk_backward"]["attrs"] == {"part": "layers"}


def test_reset_drops_replays_not_read():
    t = tracing.Tracer()
    dev = torch.device("cpu")
    rec = captured_step(t, dev)
    with t.replay(rec):
        pass
    assert len(t._replays) == 1
    t.reset()
    assert t._replays == [] and t.snapshot() == {"spans": [], "counts": {}}


def test_the_step_graph_needs_cuda():
    """The eager step is returned where the graph cannot run: CPU
    parameters (here), and ranks that share the ray axis (a `group`)."""
    cfg = configs()
    model = model_of(cfg)
    opt = make_optimizer(cfg, model.parameters())

    class Shard:
        group, sub_batch_size, draws = object(), None, []

    for shard in (None, Shard()):
        step = make_train_step(cfg, vip_nerf.render_rays, LossComputer(cfg), opt, shard)
        assert not isinstance(step, GraphedStep) and step.eager is step


@pytest.mark.parametrize("shape", [(7, 64), (3, 5, 192), (4, 1), (2, 3, 2)])
def test_the_transmittance_cumprod_has_torchs_gradient(shape):
    """The renderer's cumprod (`core/rendering.py` `_Cumprod`) is torch's,
    forward and backward bit for bit, on factors 1 - alpha + 1e-10 (never
    0), without torch's host-side test for zeros, which a CUDA graph
    cannot capture."""
    from vipnerf_tpu_torch.core.rendering import _Cumprod, exclusive_cumprod

    g = torch.Generator().manual_seed(shape[-1])
    alpha = torch.rand(shape, generator=g)
    alpha[..., ::3] = 1.0  # opaque samples: the factor is 1e-10
    x = (1.0 - alpha + 1e-10).requires_grad_()
    up = torch.randn(shape, generator=g)
    want = torch.cumprod(x, dim=-1)
    got = _Cumprod.apply(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.autograd.grad(got, x, up)[0], torch.autograd.grad(want, x, up)[0])
    ex = exclusive_cumprod(x)
    assert torch.equal(ex[..., 1:], want[..., :-1]) and torch.equal(ex[..., 0], torch.ones_like(ex[..., 0]))
    with torch.no_grad():  # rendering: the same route, untracked
        assert torch.equal(exclusive_cumprod(x), ex.detach())
