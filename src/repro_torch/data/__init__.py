from repro_torch.data.partition import dirichlet_partition, train_test_split
from repro_torch.data.synthetic import (SyntheticImageDataset,
                                        make_client_datasets, stack_datasets,
                                        synthetic_image_dataset,
                                        token_batch_stream)

__all__ = ["SyntheticImageDataset", "dirichlet_partition",
           "make_client_datasets", "stack_datasets",
           "synthetic_image_dataset", "token_batch_stream",
           "train_test_split"]
