from gpar_at_scale_torch.data.chain import make_chain_data
from gpar_at_scale_torch.data.eeg import (
    CHAIN_ORDER,
    TRAIN_POINTS,
    EEGDataset,
    generate_synthetic_eeg,
    load_eeg,
    load_eeg_csv,
)
from gpar_at_scale_torch.data.native_io import native_available, read_csv
from gpar_at_scale_torch.data.toy import ToyDataset, generate_big_dataset, generate_small_dataset

__all__ = [
    "CHAIN_ORDER", "TRAIN_POINTS", "EEGDataset", "generate_synthetic_eeg", "load_eeg",
    "load_eeg_csv", "make_chain_data", "native_available", "read_csv", "ToyDataset", "generate_big_dataset",
    "generate_small_dataset",
]
