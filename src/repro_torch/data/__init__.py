from repro_torch.data.pipeline import DataIterator, IteratorState
from repro_torch.data.synthetic import SyntheticLMDataset, SyntheticTask, make_batch_specs
