"""The STEP optimizer (paper Algorithm 1): two-phase Adam whose variance is
frozen into a preconditioner (counterpart of ``repro/core/step_optimizer.py``).

Phase 1 (precondition): plain Adam; ``v`` is updated every step and
AutoSwitch watches its per-coordinate change.  No mask is applied.

Phase 2 (mask learning): the bias-corrected variance at the switch step is
frozen into ``P* = sqrt(v̂_{t0}) + eps`` and never updated again; only the
momentum keeps integrating the (STE) gradients:

    w_{t+1} = w_t - γ_t * m̂_{t+1} / P*            (Algorithm 1, line 20)

The reference traces both phases branch-free (``jnp.where`` on a device
flag).  Here the phase flag, ``t0`` and the step count are host values, so
each step runs only its phase's arithmetic; the one host sync is
AutoSwitch's ``z_bar < eps`` read in phase 1 (``core/autoswitch.py``).
Moments advance in place (``optim/base.py``).

Ablation hooks (paper §6): ``switch_at`` fixes t0 (Ablation III);
``update_v_in_phase2`` keeps updating ``v`` in phase 2 (Ablation IV).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.autoswitch import (
    AutoSwitchConfig,
    AutoSwitchState,
    autoswitch_step,
    init_autoswitch,
    variance_change_sample,
)
from repro_torch.optim.adam import zeros_f32
from repro_torch.optim.base import (
    GradientTransformation,
    Schedule,
    bias_correction,
    leaves_by_name,
    lr_at,
    tree_like,
)
from repro_torch.utils.tree import tree_leaves, tree_map_with_name


@dataclasses.dataclass(frozen=True)
class StepConfig:
    learning_rate: Schedule = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    autoswitch: AutoSwitchConfig = dataclasses.field(default_factory=AutoSwitchConfig)
    switch_at: Optional[int] = None  # fixed t0 (overrides AutoSwitch)
    update_v_in_phase2: bool = False  # Ablation IV (paper shows: keep False)

    def __post_init__(self):
        # AutoSwitch's window follows beta2 unless overridden
        if self.autoswitch.beta2 != self.b2:
            object.__setattr__(self, "autoswitch",
                               dataclasses.replace(self.autoswitch, beta2=self.b2))


class StepState(NamedTuple):
    step: int  # global step t
    m: dict  # first moment
    v: dict  # second moment (live in phase 1; frozen afterwards)
    precond: dict  # P* = sqrt(v̂_{t0}) + eps (ones until the switch)
    phase2: bool  # inside the mask-learning phase?
    t0: int  # switch step (0 until it happens)
    autoswitch: AutoSwitchState
    z_bar: torch.Tensor  # last window mean of the variance change (telemetry)


def step_optimizer(cfg: StepConfig) -> GradientTransformation:
    """STEP as a GradientTransformation.  ``update(grads, state, params)``
    takes gradients already computed through the recipe's masking (Eq. 8/9,
    ``core/recipes.py``); it implements the two-phase moment logic only."""
    asw = cfg.autoswitch

    def init(params) -> StepState:
        dev = tree_leaves(params)[0].device
        return StepState(
            step=0, m=zeros_f32(params), v=zeros_f32(params),
            precond=tree_map_with_name(
                lambda _, p: torch.ones_like(p, dtype=torch.float32), params),
            phase2=False, t0=0, autoswitch=init_autoswitch(asw, dev),
            z_bar=torch.tensor(float("inf"), device=dev),
        )

    @torch.no_grad()
    def update(grads, state: StepState, params=None):
        t = state.step + 1
        in_p2 = state.phase2  # the phase flag *entering* this step
        b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
        bc1, bc2 = bias_correction(b1, t), bias_correction(b2, t)

        # AutoSwitch samples the pre-update v, so before v advances in place
        z_t = variance_change_sample(grads, state.v, asw)
        asw_state, z_bar, crit = autoswitch_step(
            state.autoswitch, z_t, t, asw, decide=not in_p2 and cfg.switch_at is None)
        if cfg.switch_at is not None:
            crit = t >= cfg.switch_at
        switch_now = not in_p2 and crit
        live_v = not in_p2 or cfg.update_v_in_phase2
        frozen = in_p2 and not cfg.update_v_in_phase2
        lr = lr_at(cfg.learning_rate, t)

        names, (gs, ms, vs, pcs) = leaves_by_name(grads, state.m, state.v, state.precond)
        out = []
        for g, mm, vv, pc in zip(gs, ms, vs, pcs):
            g = g.float()
            mm.mul_(b1).add_((1 - b1) * g)  # momentum: both phases (Alg. 1 l.4, l.18)
            if live_v:
                vv.mul_(b2).add_((1 - b2) * g.square())
            if switch_now:  # freeze the preconditioner (Alg. 1 l.11)
                pc.copy_(torch.sqrt(vv / bc2) + eps)
            d = (mm / bc1) / (pc if frozen else torch.sqrt(vv / bc2) + eps)
            out.append(d.mul_(-lr))
        return tree_like(names, out), StepState(
            step=t, m=state.m, v=state.v, precond=state.precond,
            phase2=in_p2 or crit, t0=t if switch_now else state.t0,
            autoswitch=asw_state, z_bar=z_bar,
        )

    return GradientTransformation(init, update)
