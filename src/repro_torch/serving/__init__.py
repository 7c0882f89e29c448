from repro_torch.serving.engine import DecodeEngine, GenerationResult
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.serving.prefix_cache import PrefixIndex
from repro_torch.serving.sampling import SamplingParams
