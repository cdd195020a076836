from .loader import DATASET_REGISTRY, build_dataset, construct_loader, shuffle_dataset  # noqa
