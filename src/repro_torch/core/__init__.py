from repro_torch.core.masking import NMSparsity
from repro_torch.core.recipes import Recipe, make_recipe
from repro_torch.core.sparsity_config import SparsityConfig
