from repro_torch.data.partition import dirichlet_partition, train_test_split
from repro_torch.data.synthetic import (SyntheticImageDataset,
                                        make_client_datasets, stack_datasets,
                                        synthetic_image_dataset)

__all__ = ["SyntheticImageDataset", "dirichlet_partition",
           "make_client_datasets", "stack_datasets",
           "synthetic_image_dataset", "train_test_split"]
