from repro_torch.core.autoswitch import (
    AutoSwitchConfig,
    AutoSwitchState,
    autoswitch_step,
    criterion_autoswitch_offline,
    criterion_relative_norm,
    criterion_staleness,
    init_autoswitch,
    variance_change_sample,
)
from repro_torch.core.masking import (
    NMSparsity,
    masked_no_ste,
    nm_compress,
    nm_decompress,
    nm_mask,
    nm_mask_dynamic,
    sparsity_fraction,
    sr_ste_grad_term,
    straight_through,
    straight_through_mask,
)
from repro_torch.core.domino import assigned_ratios, domino_search
from repro_torch.core.recipes import RECIPES, Recipe, RecipeState, make_recipe
from repro_torch.core.sparsity_config import SparsityConfig, maskable_map, sparsity_report
from repro_torch.core.step_optimizer import StepConfig, StepState, step_optimizer
