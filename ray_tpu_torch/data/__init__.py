"""Data library — distributed datasets (port of ``ray_tpu/data``; reference
``python/ray/data/``).

Lazy plans over Arrow blocks; per-block transforms pipeline through
ref-chaining (the owner/scheduler overlap stages automatically), barrier
ops (shuffle/sort/repartition) materialize. ``iter_batches``/``split``
are the training-ingest path feeding JaxTrainer workers, and
``iter_torch_batches`` lands each batch on the card.
"""

from ray_tpu_torch.data.context import DataContext  # noqa: F401
from ray_tpu_torch.data.dataset import (  # noqa: F401
    DataIterator,
    Dataset,
    GroupedDataset,
)
from ray_tpu_torch.data.execution import ActorPoolStrategy  # noqa: F401
from ray_tpu_torch.data.datasource import (  # noqa: F401
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    from_torch,
    range,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
    read_webdataset,
    write_csv,
    write_json,
    write_parquet,
    write_tfrecords,
)
from ray_tpu_torch.data.connectors import (  # noqa: F401
    read_bigquery,
    read_iceberg,
    read_lance,
    read_mongo,
)

from ray_tpu_torch.util.usage import record_library_usage as _record_usage
_record_usage("data")
del _record_usage
