"""AutoSwitch (paper Algorithm 2): when to leave the precondition phase
(counterpart of ``repro/core/autoswitch.py``).

Per step it samples the per-coordinate variance change

    Option I :  Z_t = d^{-1} ||v_t - v_{t-1}||_1           (arithmetic mean)
    Option II:  Z_t = exp(d^{-1} ||log|v_t - v_{t-1}|||_1)  (geometric mean)

from ``v_t - v_{t-1} = (1 - beta2)(g_t^2 - v_{t-1})`` (the gradient and the
*pre-update* variance of the same step, over every leaf), keeps the last
``T_w = floor(1/(1-beta2))`` samples in a ring buffer on the device, and
fires once their mean drops below Adam's own ``eps``, within the optional
clipping bounds ``[T_min, T_max]``.

The reference decides on the device inside a jitted step.  Here the sample
and the window stay on the device, and the decision is read on the host:
the comparison ``z_bar < eps`` costs one host sync, taken only on steps
where it can change the outcome (window full, past ``t_min``, not already
forced by ``t_max``).

The offline criteria at the end replay recorded traces, as the paper
profiles the baselines of its Table 1: Eq. (10) (relative norm change),
Eq. (11) (staleness) and Algorithm 2 itself.  They take 1-D tensors on
any device (or anything ``torch.as_tensor`` takes) and return Python ints;
the replay of Algorithm 2 runs in f32, as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class AutoSwitchConfig:
    beta2: float = 0.999
    eps: float = 1e-8  # threshold = Adam's eps (paper: reuse, don't tune)
    option: str = "I"  # "I" arithmetic | "II" geometric
    window: Optional[int] = None  # override T_w (default floor(1/(1-beta2)))
    t_min: Optional[int] = None  # optional clipping (paper: 0.1 * T)
    t_max: Optional[int] = None  # optional clipping (paper: 0.5 * T)

    @property
    def t_w(self) -> int:
        if self.window is not None:
            return int(self.window)
        # round first: 1/(1-0.999) is 999.9999... in float64, the paper's T_w 1000
        return max(1, int(round(1.0 / (1.0 - self.beta2), 6)))


class AutoSwitchState(NamedTuple):
    window: torch.Tensor  # (T_w,) f32 ring buffer of Z_t samples, on the device
    count: int  # samples recorded so far


def init_autoswitch(cfg: AutoSwitchConfig, device="cuda") -> AutoSwitchState:
    """An empty window on the card, unless the caller asks for the CPU."""
    return AutoSwitchState(window=torch.zeros((cfg.t_w,), device=resolve_device(device)),
                           count=0)


def variance_change_sample(grads, v, cfg: AutoSwitchConfig,
                           d: Optional[int] = None) -> torch.Tensor:
    """Z_t from this step's gradients and the pre-update variance, as a 0-d
    f32 tensor; ``d`` is the total coordinate count (of ``v`` if not
    given)."""
    leaves_g, leaves_v = tree_leaves(grads), tree_leaves(v)
    if d is None:
        d = sum(x.numel() for x in leaves_v)
    d = float(d)
    c = 1.0 - cfg.beta2
    if cfg.option == "I":
        tot = sum((g.float().square() - vv).abs().sum() for g, vv in zip(leaves_g, leaves_v))
        return c * tot / d
    if cfg.option == "II":
        tiny = 1e-30
        tot = sum(torch.log(c * (g.float().square() - vv).abs() + tiny).sum()
                  for g, vv in zip(leaves_g, leaves_v))
        return torch.exp(tot / d)
    raise ValueError(f"unknown AutoSwitch option {cfg.option!r}")


def autoswitch_step(
    state: AutoSwitchState, z_t: torch.Tensor, t: int, cfg: AutoSwitchConfig,
    decide: bool = True,
) -> tuple[AutoSwitchState, torch.Tensor, bool]:
    """Record one sample; return ``(new_state, z_bar, switch_now)``.

    ``z_bar`` stays on the device.  ``switch_now`` is Algorithm 2's return
    value with the optional clipping; with ``decide=False`` (the caller is
    past the switch and ignores it) it is False and costs no host sync.
    The window is updated in place."""
    state.window[state.count % cfg.t_w] = z_t.to(torch.float32)
    count = state.count + 1
    z_bar = state.window.sum() / cfg.t_w
    crit = False
    if decide:
        if cfg.t_max is not None and t > cfg.t_max:
            crit = True
        elif count >= cfg.t_w and (cfg.t_min is None or t > cfg.t_min):
            crit = bool(z_bar < np.float32(cfg.eps))  # host sync
    return AutoSwitchState(window=state.window, count=count), z_bar, crit



# ---------------------------------------------------------------------------
# Baseline switching criteria (paper Eq. 10 / Eq. 11) and Algorithm 2 over a
# recorded trace: the offline replays of the paper's Table 1.
# ---------------------------------------------------------------------------


def _trace(x) -> torch.Tensor:
    """A recorded trace as a 1-D float tensor where it lies (integers as f32)."""
    v = torch.as_tensor(x)
    return v if v.is_floating_point() else v.float()


def _first(hits: torch.Tensor) -> int:
    """Index of the first True of a 1-D bool tensor; its last index if
    none is (the reference's ``nonzero(size=1, fill_value=len - 1)``)."""
    return int(hits.int().argmax()) if bool(hits.any()) else hits.shape[0] - 1


def criterion_relative_norm(v_norms, threshold: float = 0.5) -> int:
    """Agarwal et al. Eq. (10): the first t with |‖v_t‖ - ‖v_{t-1}‖| /
    ‖v_{t-1}‖ < threshold.  ``v_norms`` is the trace of ‖v_t‖₂ a step;
    ``len - 1`` if never met."""
    v = _trace(v_norms)
    rel = (v[1:] - v[:-1]).abs() / v[:-1].clamp_min(1e-30)
    return _first(rel < threshold) + 1


def criterion_staleness(v_l1_norms, beta2: float = 0.999, threshold: float = 0.96) -> int:
    """Tang et al. Eq. (11): the first t with ‖v_t‖₁ / ‖v_{t-k}‖₁ >
    threshold, k = floor(1/(1-beta2)); ``len - 1`` for a trace of at most
    k samples, ``len - 1`` if never met."""
    v = _trace(v_l1_norms)
    k = max(1, int(1.0 / (1.0 - beta2)))
    if v.shape[0] <= k:
        return v.shape[0] - 1
    ratio = v[k:] / v[:-k].clamp_min(1e-30)
    return _first(ratio > threshold) + k


def criterion_autoswitch_offline(z_trace, cfg: AutoSwitchConfig) -> int:
    """Algorithm 2 over a recorded Z_t trace: the first step whose window
    mean (the last ``T_w`` samples, in f32) is below ``eps``, within the
    clip (past ``t_min``; any step past ``t_max``); ``len - 1`` for a
    trace shorter than the window or if never met.  The means are
    differences of f32 prefix sums, as the reference's, so a mean below
    about 1e-7 of the trace's sum is lost in rounding (and the reference's
    prefix sum adds in another order)."""
    z = _trace(z_trace).float()
    t_w = cfg.t_w
    if z.shape[0] < t_w:
        return z.shape[0] - 1
    csum = torch.cat([z.new_zeros(1), torch.cumsum(z, 0)])
    zbar = (csum[t_w:] - csum[:-t_w]) / t_w  # mean of the window ending at t_w - 1 + i
    t_idx = torch.arange(t_w - 1, z.shape[0], device=z.device)
    ok = zbar < np.float32(cfg.eps)
    if cfg.t_min is not None:
        ok = ok & (t_idx > cfg.t_min)
    if cfg.t_max is not None:
        ok = ok | (t_idx > cfg.t_max)
    return int(t_idx[_first(ok)])
