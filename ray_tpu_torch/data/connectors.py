"""External-store connectors: MongoDB, BigQuery, Lance, Iceberg (port of
``ray_tpu/data/connectors.py``).

Reference: ``python/ray/data/_internal/datasource/{mongo,bigquery,lance,
iceberg}_datasource.py``. Same shape here: plan a list of independent
read tasks from the store's own partitioning unit (Mongo _id ranges,
BigQuery result pages, Lance fragments, Iceberg file-scan tasks), each
task yielding one Arrow block. The client libraries are not part of this
image; every reader imports lazily and raises a clear error naming the
missing dependency — the planning/conversion logic is exercised in tests
against stub clients.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch.data import block as B
from ray_tpu_torch.data.dataset import Dataset, _Read


def _missing(lib: str, reader: str):
    return ImportError(
        f"{reader} requires the optional dependency {lib!r}, which is not "
        f"installed. pip install {lib}")


def read_mongo(uri: str, database: str, collection: str, *,
               query: Optional[Dict[str, Any]] = None,
               projection: Optional[Dict[str, Any]] = None,
               parallelism: int = 4) -> Dataset:
    """One read task per skip/limit range of the (sorted-by-_id) result
    set (reference mongo_datasource.py partitioning)."""
    try:
        import pymongo  # noqa: F401
    except ImportError as e:
        raise _missing("pymongo", "read_mongo") from e
    import pymongo

    client = pymongo.MongoClient(uri)
    total = client[database][collection].count_documents(query or {})
    client.close()
    n = max(1, min(parallelism, total or 1))
    per = -(-max(total, 1) // n)  # ceil

    def make(skip, limit):
        def read():
            import pymongo as _pm

            c = _pm.MongoClient(uri)
            try:
                docs = list(c[database][collection]
                            .find(query or {}, projection)
                            .sort("_id", 1).skip(skip).limit(limit))
            finally:
                c.close()
            for d in docs:
                d.pop("_id", None) if projection is None else None
            return B.block_from_rows(docs)

        return read

    return Dataset([_Read([make(i * per, per) for i in range(n)])])


def read_bigquery(project_id: str, *, query: Optional[str] = None,
                  dataset: Optional[str] = None,
                  block_rows: int = 10_000) -> Dataset:
    """Query (or full-table) read, one block per ``block_rows`` chunk
    (reference bigquery_datasource.py; the reference's Storage-API read
    streams need the cloud service — pagination is the lib-only path)."""
    try:
        from google.cloud import bigquery  # noqa: F401
    except ImportError as e:
        raise _missing("google-cloud-bigquery", "read_bigquery") from e
    if (query is None) == (dataset is None):
        raise ValueError("pass exactly one of query= or dataset=")

    def make():
        def read():
            from google.cloud import bigquery as bq

            client = bq.Client(project=project_id)
            if query is not None:
                it = client.query(query).result(page_size=block_rows)
            else:
                it = client.list_rows(dataset, page_size=block_rows)
            rows = [dict(r) for r in it]
            return B.block_from_rows(rows)

        return read

    return Dataset([_Read([make()])])


def read_lance(uri: str, *, columns: Optional[List[str]] = None,
               filter: Optional[str] = None) -> Dataset:
    """One read task per Lance fragment (reference lance_datasource.py)."""
    try:
        import lance  # noqa: F401
    except ImportError as e:
        raise _missing("pylance", "read_lance") from e
    import lance

    ds = lance.dataset(uri)
    fragment_ids = [f.fragment_id for f in ds.get_fragments()]

    def make(fid):
        def read():
            import lance as _lance

            d = _lance.dataset(uri)
            frag = next(f for f in d.get_fragments()
                        if f.fragment_id == fid)
            return frag.to_table(columns=columns, filter=filter)

        return read

    return Dataset([_Read([make(f) for f in fragment_ids])])


def read_iceberg(table_identifier: str, *,
                 catalog_kwargs: Optional[Dict[str, Any]] = None,
                 row_filter: Optional[str] = None,
                 selected_fields: Optional[List[str]] = None) -> Dataset:
    """One read task per Iceberg file-scan task (reference
    iceberg_datasource.py over pyiceberg's plan_files)."""
    try:
        import pyiceberg.catalog  # noqa: F401
    except ImportError as e:
        raise _missing("pyiceberg", "read_iceberg") from e
    from pyiceberg.catalog import load_catalog

    catalog = load_catalog(**(catalog_kwargs or {}))
    table = catalog.load_table(table_identifier)
    scan_kwargs: Dict[str, Any] = {}
    if row_filter is not None:
        scan_kwargs["row_filter"] = row_filter
    if selected_fields is not None:
        scan_kwargs["selected_fields"] = tuple(selected_fields)
    scan = table.scan(**scan_kwargs)
    file_paths = [t.file.file_path for t in scan.plan_files()]

    def make(path):
        def read():
            from pyiceberg.catalog import load_catalog as _lc

            cat = _lc(**(catalog_kwargs or {}))
            tbl = cat.load_table(table_identifier)
            kw = dict(scan_kwargs)
            t = next(t for t in tbl.scan(**kw).plan_files()
                     if t.file.file_path == path)
            from pyiceberg.io.pyarrow import ArrowScan

            return ArrowScan(
                tbl.metadata, tbl.io, tbl.scan(**kw).projection(),
                kw.get("row_filter", True)).to_table([t])

        return read

    return Dataset([_Read([make(p) for p in file_paths])])
