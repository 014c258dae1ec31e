from repro_torch.data.synthetic import (SyntheticDataset,
                                       make_markov_lm_dataset,
                                       make_prototype_image_dataset)
from repro_torch.data.pipeline import DataPipeline, replica_batch_indices
