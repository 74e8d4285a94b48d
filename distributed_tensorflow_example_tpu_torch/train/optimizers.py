"""Optimizer construction (port of ``distributed_tensorflow_example_tpu/
train/optimizers.py``): schedule -> clip -> optimizer -> weight decay.

The reference builds optax transformations; here each is a
:class:`Transform`, a pair of plain functions over a list of tensors (the
flattened parameters, gradients or updates), written in optax's order of
operations so the port's updates match the reference's at f32 rounding:

- ``clip_by_global_norm``: optax's rule (scale by ``max_norm / norm``
  only when ``norm >= max_norm``; no ``+1e-6`` as in
  ``torch.nn.utils.clip_grad_norm_``);
- ``scale_by_adam``: moments ``(1 - b) g^k + b m``, bias correction by
  ``1 - b^count`` at the incremented count, ``m / (sqrt(v + eps_root) +
  eps)`` with ``eps = 1e-8`` and ``eps_root = 0``;
- ``add_decayed_weights``: ``u + wd p`` on the masked leaves;
- ``scale_by_learning_rate``: ``-lr(count) u``, ``count`` being the number
  of updates applied before this one;
- ``scale_by_trust_ratio``: ``u * coeff ||p|| / (||u|| + eps)`` a leaf,
  1 where either norm is 0 (LARS and LAMB);
- ``masked``: the inner transform on the masked leaves only, the others
  passed through unchanged (optax's ``wrappers.masked``).

Every state is a tuple, dict or list of tensors on the parameters'
device, counts included, so a step runs with no host sync and a caller
can keep a state unchanged with ``torch.where`` (the sync step's
anomaly guard). Schedules are functions of a step count (an int32
tensor, or anything ``torch.as_tensor`` takes) returning an f32 tensor.

Ported: sgd, momentum, adam, adamw, lars and lamb, the eight decay
schedules with linear warmup, the global-norm and elementwise clips and
the weight-decay mask. adafactor arrives with slice A3c-3b, bf16 moments
and the parameter EMA with slice A5b: they raise.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..config import OptimizerConfig

Tensors = list[torch.Tensor]
Schedule = Callable[[Any], torch.Tensor]

_INT32_MAX = 2**31 - 1


class Transform(NamedTuple):
    """optax's ``GradientTransformation`` over tensor lists:
    ``init(params) -> state``, ``update(updates, state, params) ->
    (updates, state)``."""

    init: Callable[[Tensors], Any]
    update: Callable[..., tuple[Tensors, Any]]


def _count(params: Tensors) -> torch.Tensor:
    dev = params[0].device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    return torch.where(count < _INT32_MAX, count + 1, count)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def global_norm(xs: Tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(x * x) for x in xs))


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    return [(p + u).to(p.dtype) for p, u in zip(params, updates)]


def chain(*parts: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in parts)

    def update(updates, state, params=None):
        new = []
        for t, s in zip(parts, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return Transform(init, update)


def _stateless(fn) -> Transform:
    return Transform(lambda params: (),
                     lambda updates, state, params=None: (fn(updates, params),
                                                          state))


def clip_by_global_norm(max_norm: float) -> Transform:
    def fn(updates, params):
        g = global_norm(updates)
        trigger = g < max_norm
        return [torch.where(trigger, t, (t / g.to(t.dtype)) * max_norm)
                for t in updates]
    return _stateless(fn)


def clip(max_delta: float) -> Transform:
    return _stateless(lambda updates, params: [
        torch.clamp(t, -max_delta, max_delta) for t in updates])


def add_decayed_weights(weight_decay: float, mask=None) -> Transform:
    """``u + wd p``; ``mask(params)`` -> one bool per leaf (None: all)."""
    def fn(updates, params):
        if params is None:
            raise ValueError("add_decayed_weights needs params in update")
        keep = mask(params) if mask is not None else [True] * len(params)
        return [g + weight_decay * p if m else g
                for g, p, m in zip(updates, params, keep)]
    return _stateless(fn)


def masked(inner: Transform, mask) -> Transform:
    """``inner`` on the leaves ``mask(params)`` selects (None: all), the
    others passed through; ``inner`` must be stateless (the trust ratio
    is), so the state is empty as optax's ``MaskedState`` of an empty
    inner state is in a checkpoint."""
    if mask is None:
        return inner

    def fn(updates, params):
        keep = mask(params)
        sel = [i for i, m in enumerate(keep) if m]
        out, _ = inner.update([updates[i] for i in sel], (),
                              [params[i] for i in sel])
        new = list(updates)
        for i, u in zip(sel, out):
            new[i] = u
        return new
    return _stateless(fn)


def scale_by_trust_ratio(trust_coefficient: float = 1.0,
                         eps: float = 0.0) -> Transform:
    """optax's rule, a leaf: ``u * coeff ||p|| / (||u|| + eps)``, the
    ratio 1 where ``||p||`` or ``||u||`` is 0."""
    def fn(updates, params):
        if params is None:
            raise ValueError("scale_by_trust_ratio needs params in update")
        out = []
        for u, p in zip(updates, params):
            pn = torch.linalg.vector_norm(p)
            un = torch.linalg.vector_norm(u)
            ratio = trust_coefficient * pn / (un + eps)
            ratio = torch.where((pn == 0) | (un == 0),
                                torch.ones((), dtype=p.dtype,
                                           device=p.device), ratio)
            out.append(u * ratio)
        return out
    return _stateless(fn)


def scale_by_adam(eps: float = 1e-8) -> Transform:
    """optax's defaults: b1 0.9, b2 0.999, eps 1e-8, eps_root 0."""
    b1, b2 = 0.9, 0.999

    def init(params):
        return {"count": _count(params),
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(updates, state, params=None):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(updates, state["mu"])]
        nu = [(1 - b2) * (g * g) + b2 * n
              for g, n in zip(updates, state["nu"])]
        count = _safe_increment(state["count"])
        c = count.float()
        bc1 = 1 - torch.pow(_f32(b1).to(c.device), c)
        bc2 = 1 - torch.pow(_f32(b2).to(c.device), c)
        out = [(m / bc1) / (torch.sqrt(n / bc2) + eps)
               for m, n in zip(mu, nu)]
        return out, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def trace(decay: float) -> Transform:
    """Momentum: ``t = g + decay t``, the update is the new trace."""
    def init(params):
        return {"trace": [torch.zeros_like(p) for p in params]}

    def update(updates, state, params=None):
        new = [g + decay * t for g, t in zip(updates, state["trace"])]
        return new, {"trace": new}

    return Transform(init, update)


def scale_by_learning_rate(schedule: Schedule) -> Transform:
    """``-lr(count) u``; the count is the updates applied before."""
    def init(params):
        return {"count": _count(params)}

    def update(updates, state, params=None):
        step_size = -1 * schedule(state["count"])
        out = [step_size.to(g.dtype) * g for g in updates]
        return out, {"count": _safe_increment(state["count"])}

    return Transform(init, update)


def sgd(schedule: Schedule, momentum: float | None = None) -> Transform:
    """optax's sgd: (trace or identity) then the learning rate, so the
    state has optax's layout (the checkpoint keys name its positions)."""
    first = (trace(momentum) if momentum is not None
             else _stateless(lambda updates, params: updates))
    return chain(first, scale_by_learning_rate(schedule))


def adam(schedule: Schedule) -> Transform:
    return chain(scale_by_adam(), scale_by_learning_rate(schedule))


def adamw(schedule: Schedule, weight_decay: float, mask=None) -> Transform:
    return chain(scale_by_adam(), add_decayed_weights(weight_decay, mask),
                 scale_by_learning_rate(schedule))


def lamb(schedule: Schedule, weight_decay: float = 0.0,
         mask=None) -> Transform:
    """optax's lamb: Adam moments with eps 1e-6 -> decayed weights on the
    masked leaves -> the trust ratio on every leaf -> the learning
    rate."""
    return chain(scale_by_adam(eps=1e-6),
                 add_decayed_weights(weight_decay, mask),
                 scale_by_trust_ratio(), scale_by_learning_rate(schedule))


def lars(schedule: Schedule, weight_decay: float = 0.0, mask=None,
         momentum: float = 0.9, trust_coefficient: float = 0.001
         ) -> Transform:
    """optax's lars: decayed weights -> the trust ratio (coefficient
    0.001) on the masked leaves -> the learning rate -> the momentum
    trace, so the trace accumulates steps already scaled by -lr. One
    mask serves the decay and the trust ratio (None: every leaf)."""
    return chain(add_decayed_weights(weight_decay, mask),
                 masked(scale_by_trust_ratio(trust_coefficient), mask),
                 scale_by_learning_rate(schedule), trace(momentum))


# ---------------------------------------------------------------------------
# schedules: optax's, over torch tensors
# ---------------------------------------------------------------------------

def _count_of(count) -> torch.Tensor:
    count = torch.as_tensor(count)
    return count if count.is_floating_point() else count.to(torch.int32)


def _constant(value: float) -> Schedule:
    return lambda count: torch.full((), value, dtype=torch.float32,
                                    device=_count_of(count).device)


def _polynomial(init: float, end: float, power: float,
                steps: int) -> Schedule:
    if steps <= 0:
        return _constant(init)

    def sched(count):
        c = torch.clamp(_count_of(count), 0, steps)
        frac = 1 - c / steps
        return (init - end) * (frac ** power) + end
    return sched


def _piecewise(init: float, boundaries_and_scales: dict) -> Schedule:
    """optax's rule; ``boundaries_and_scales`` is not empty."""
    if any(scale < 0.0 for scale in boundaries_and_scales.values()):
        raise ValueError("piecewise schedule expects non-negative scales")

    def sched(count):
        count = _count_of(count)
        v = init
        for threshold, scale in sorted(boundaries_and_scales.items()):
            indicator = torch.clamp_min(
                torch.sign(threshold - count).float(), 0.0)
            v = v * indicator + (1 - indicator) * scale * v
        return v
    return sched


def _exponential(init: float, steps: int, rate: float) -> Schedule:
    if steps <= 0 or rate == 0:
        return _constant(init)

    def sched(count):
        dec = _count_of(count)
        p = dec / steps
        return torch.where(dec <= 0, _f32(init).to(p.device),
                           init * torch.pow(rate, p))
    return sched


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")
    steps = float(decay_steps)

    def sched(count):
        c = torch.clamp_max(_count_of(count).float(), steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / steps))
        return init * ((1 - alpha) * cosine ** 1.0 + alpha)
    return sched


def _join(scheds: list, boundaries: list) -> Schedule:
    def sched(count):
        count = _count_of(count)
        out = scheds[0](count)
        for boundary, s in zip(boundaries, scheds[1:]):
            out = torch.where(count < boundary, out, s(count - boundary))
        return out
    return sched


def make_schedule(cfg: OptimizerConfig) -> Schedule:
    """The learning rate as a function of the step count: the reference's
    eight schedules (tf.train semantics at ABSOLUTE steps) behind an
    optional linear warmup, with its validation."""
    base = cfg.learning_rate
    w = cfg.warmup_steps
    if cfg.decay_schedule == "piecewise":
        if not cfg.decay_boundaries:
            raise ValueError(
                "decay_schedule='piecewise' needs decay_boundaries")
        if any(int(b) <= w for b in cfg.decay_boundaries):
            raise ValueError(
                f"decay_boundaries {cfg.decay_boundaries} must all lie "
                f"after warmup_steps={w}")
        sched = _piecewise(base, {int(b) - w: cfg.decay_factor
                                  for b in cfg.decay_boundaries})
    elif cfg.decay_schedule == "exponential":
        if cfg.decay_steps <= 0:
            raise ValueError(
                "decay_schedule='exponential' needs decay_steps > 0")
        sched = _exponential(base * cfg.decay_factor ** (w / cfg.decay_steps),
                             cfg.decay_steps, cfg.decay_factor)
    elif cfg.decay_schedule == "polynomial":
        horizon = cfg.decay_steps if cfg.decay_steps > 0 else cfg.total_steps
        if horizon <= w:
            raise ValueError(
                "decay_schedule='polynomial' needs decay_steps (or "
                f"total_steps) > warmup_steps; got horizon={horizon}, "
                f"warmup_steps={w}")
        poly = _polynomial(base, cfg.end_learning_rate, cfg.decay_power,
                           horizon)
        sched = ((lambda count: poly(_count_of(count) + w)) if w > 0
                 else poly)
    elif cfg.decay_schedule == "natural_exp":
        if cfg.decay_steps <= 0:
            raise ValueError(
                "decay_schedule='natural_exp' needs decay_steps > 0")
        k = cfg.decay_factor / cfg.decay_steps
        sched = _exponential(base * math.exp(-k * w), cfg.decay_steps,
                             math.exp(-cfg.decay_factor))
    elif cfg.decay_schedule == "inverse_time":
        if cfg.decay_steps <= 0:
            raise ValueError(
                "decay_schedule='inverse_time' needs decay_steps > 0")
        k = cfg.decay_factor / cfg.decay_steps

        def sched(count):
            return base / (1.0 + k * (_count_of(count) + w))
    elif cfg.decay_schedule == "constant" or cfg.total_steps <= 0:
        sched = _constant(base)
    elif cfg.decay_schedule == "cosine":
        sched = _cosine(base, max(1, cfg.total_steps - w),
                        (cfg.end_learning_rate / base) if base else 0.0)
    elif cfg.decay_schedule == "linear":
        sched = _polynomial(base, 0.0, 1, max(1, cfg.total_steps - w))
    else:
        raise ValueError(f"unknown decay_schedule {cfg.decay_schedule!r}")
    if w > 0:
        sched = _join([_polynomial(0.0, base, 1, w), sched], [w])
    return sched


def _wd_mask(cfg: OptimizerConfig):
    """Decay mask per ``wd_mask``: ``exclude_1d`` decays only leaves with
    ndim >= 2 (matrices, embeddings), not biases or LayerNorm params."""
    if cfg.wd_mask == "all":
        return None
    if cfg.wd_mask == "exclude_1d":
        return lambda params: [p.ndim >= 2 for p in params]
    raise ValueError(f"unknown wd_mask {cfg.wd_mask!r}")


def make_optimizer(cfg: OptimizerConfig) -> Transform:
    """clip-by-global-norm -> clip-by-value -> the optimizer (+ decayed
    weights), as the reference chains them."""
    name = cfg.name.lower()
    if cfg.moment_dtype == "bfloat16" and name in ("lars", "lamb"):
        what = "accumulator dtype" if name == "lars" else "mu_dtype"
        raise ValueError(
            f"moment_dtype=bfloat16 is not supported for {name} (optax."
            f"{name} exposes no {what}); the flag would be a silent no-op")
    if cfg.moment_dtype == "bfloat16":
        raise NotImplementedError("moment_dtype='bfloat16' arrives with "
                                  "slice A5b; the port keeps f32 moments")
    if cfg.moment_dtype != "float32":
        raise ValueError(f"unknown moment_dtype {cfg.moment_dtype!r}")
    if cfg.ema_decay > 0:
        raise NotImplementedError("ema_decay (the parameter EMA) arrives "
                                  "with slice A5b")
    sched = make_schedule(cfg)
    parts: list[Transform] = []
    if cfg.grad_clip_norm > 0:
        parts.append(clip_by_global_norm(cfg.grad_clip_norm))
    if cfg.grad_clip_value > 0:
        parts.append(clip(cfg.grad_clip_value))
    mask = _wd_mask(cfg)
    if name == "sgd":
        parts.append(sgd(sched))
    elif name == "momentum":
        parts.append(sgd(sched, momentum=cfg.momentum))
    elif name == "adam":
        parts.append(adam(sched))
    elif name == "adamw":
        parts.append(adamw(sched, cfg.weight_decay, mask))
    elif name == "lars":
        # the biases and norm scales stay out of the decay AND the trust
        # ratio under the default wd_mask; "all" applies both everywhere
        parts.append(lars(sched, cfg.weight_decay, mask, cfg.momentum))
    elif name == "lamb":
        parts.append(lamb(sched, cfg.weight_decay, mask))
    elif name == "adafactor":
        raise NotImplementedError("optimizer 'adafactor' arrives with slice "
                                  "A3c-3b; the port has sgd, momentum, adam, "
                                  "adamw, lars and lamb")
    else:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    if cfg.weight_decay > 0 and name not in ("adamw", "lars", "lamb"):
        parts.insert(-1, add_decayed_weights(cfg.weight_decay, mask))
    return chain(*parts)
