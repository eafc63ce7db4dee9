"""Datasets, partitions and batch schedules (numpy copies of ``repro.data``)."""
from .partition import node_datasets, partition_iid
from .pipeline import NodeBatches, batch_index_schedule, node_batch_iterator
from .synthetic import ImageDataset, cifar10_like, make_image_classification, mnist_like, so2sat_like

__all__ = [
    "ImageDataset",
    "NodeBatches",
    "batch_index_schedule",
    "cifar10_like",
    "make_image_classification",
    "mnist_like",
    "node_batch_iterator",
    "node_datasets",
    "partition_iid",
    "so2sat_like",
]
