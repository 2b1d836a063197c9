"""Data plane: readers that turn source records into raw-feature columns."""
from .csv import CsvReader, infer_csv_dataset, read_csv_auto  # noqa: F401
from .core import DataReader, DatasetReader  # noqa: F401
