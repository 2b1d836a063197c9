"""Data plane: readers that turn source records into raw-feature columns."""
from .csv import CsvReader, infer_csv_dataset, read_csv_auto  # noqa: F401
from .core import DataReader, DatasetReader, SimpleReader  # noqa: F401
from .aggregate import (  # noqa: F401
    AggregateParams,
    AggregateReader,
    ConditionalParams,
    ConditionalReader,
    CutOffTime,
    StreamingAggregateReader,
    StreamingConditionalReader,
    TimeStampToKeep,
    event_parity_oracle,
)
from .joins import (  # noqa: F401
    JoinedAggregateReader,
    JoinedReader,
    JoinKeys,
    JoinType,
    TimeBasedFilter,
    TimeColumn,
    join_datasets,
)
from .streaming import (  # noqa: F401
    FileStreamingReader,
    StreamExhausted,
    StreamingReader,
)
from .parquet import (  # noqa: F401
    AvroReader,
    ParquetReader,
    dataset_from_arrow,
    infer_avro_dataset,
    infer_parquet_dataset,
    read_parquet,
    write_parquet,
)
from .catalog import DataReaders  # noqa: F401
