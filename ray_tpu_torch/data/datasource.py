"""Read/write API (port of ``ray_tpu/data/datasource.py``; reference ``python/ray/data/read_api.py`` +
``datasource/`` connectors). Each read produces independent read tasks —
one per file / range shard — that execute as distributed tasks.
"""

from __future__ import annotations

import builtins
import glob as _glob
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data import block as B
from ray_tpu_torch.data.dataset import Dataset, _Read


def range(n: int, *, num_blocks: Optional[int] = None) -> Dataset:  # noqa: A001
    num_blocks = num_blocks or min(max(1, n // 1000), 64)
    per = -(-n // num_blocks)
    tasks = []
    for i in builtins.range(num_blocks):
        lo, hi = i * per, min((i + 1) * per, n)
        if lo >= hi:
            break
        tasks.append(lambda lo=lo, hi=hi: B.block_from_batch(
            {"id": np.arange(lo, hi)}))
    return Dataset([_Read(tasks)])


def from_items(items: List[Any], *, num_blocks: int = 1) -> Dataset:
    rows = [it if isinstance(it, dict) else {"item": it} for it in items]
    per = -(-len(rows) // num_blocks) if rows else 1
    tasks = []
    for i in builtins.range(num_blocks):
        chunk = rows[i * per:(i + 1) * per]
        if not chunk and i > 0:
            break
        tasks.append(lambda chunk=chunk: B.block_from_rows(chunk))
    return Dataset([_Read(tasks)])


def from_numpy(arrays: Dict[str, np.ndarray]) -> Dataset:
    return Dataset([_Read([lambda: B.block_from_batch(arrays)])])


def _expand(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith(".")))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


def read_parquet(paths, *, columns: Optional[List[str]] = None,
                 filter: Optional[List[tuple]] = None) -> Dataset:
    """Parquet with metadata-aware planning (reference
    ``ParquetDatasource``): files whose row groups exceed
    ``DataContext.target_max_block_size`` are split into one read task
    per row-group chunk (block-size-aware splitting from footer metadata
    alone); ``columns`` is projection pushdown and ``filter`` (DNF tuple
    list, e.g. ``[("x", ">", 5)]``) prunes row groups via parquet
    statistics before any data is read."""
    from ray_tpu_torch.data.context import DataContext

    files = _expand(paths)
    target = DataContext.get_current().target_max_block_size

    def make(task_path):
        def read():
            import pyarrow.parquet as pq

            return pq.read_table(task_path, columns=columns,
                                 filters=filter)

        return read

    def make_row_groups(task_path, groups):
        def read():
            import pyarrow.parquet as pq

            return pq.ParquetFile(task_path).read_row_groups(
                groups, columns=columns)

        return read

    # NB: this module exports a ``range`` READER that shadows the builtin
    _range = builtins.range
    tasks = []
    for f in files:
        n_groups, data_bytes = 1, 0
        if filter is None:  # row-group filters need the read_table path
            try:
                import pyarrow.parquet as pq

                md = pq.ParquetFile(f).metadata
                n_groups = md.num_row_groups
                data_bytes = sum(md.row_group(i).total_byte_size
                                 for i in _range(n_groups))
            except Exception:  # noqa: BLE001 — fall back to 1 task/file
                n_groups = 1
        if n_groups > 1 and data_bytes > target:
            per_task = max(1, round(n_groups * target / data_bytes))
            for lo in _range(0, n_groups, per_task):
                tasks.append(make_row_groups(
                    f, list(_range(lo, min(lo + per_task, n_groups)))))
        else:
            tasks.append(make(f))
    return Dataset([_Read(tasks)])


def read_csv(paths) -> Dataset:
    files = _expand(paths)

    def make(task_path):
        def read():
            import pyarrow.csv as pcsv

            return pcsv.read_csv(task_path)

        return read

    return Dataset([_Read([make(f) for f in files])])


def read_json(paths) -> Dataset:
    files = _expand(paths)

    def make(task_path):
        def read():
            import pyarrow.json as pjson

            return pjson.read_json(task_path)

        return read

    return Dataset([_Read([make(f) for f in files])])


def read_text(paths, *, drop_empty_lines: bool = True) -> Dataset:
    """One row per line, column ``text`` (reference:
    ``data/read_api.py read_text``)."""
    files = _expand(paths)

    def make(task_path):
        def read():
            with open(task_path, "r", encoding="utf-8") as f:
                lines = f.read().splitlines()
            if drop_empty_lines:
                lines = [ln for ln in lines if ln]
            return B.block_from_rows([{"text": ln} for ln in lines])

        return read

    return Dataset([_Read([make(f) for f in files])])


def read_binary_files(paths, *, include_paths: bool = False) -> Dataset:
    """One row per file, column ``bytes`` (+ ``path``) (reference:
    ``read_binary_files``). The block layer holds the payloads as
    object-dtype values, so arbitrary blobs ride the normal pipeline."""
    files = _expand(paths)

    def make(task_path):
        def read():
            with open(task_path, "rb") as f:
                data = f.read()
            row = {"bytes": data}
            if include_paths:
                row["path"] = task_path
            return B.block_from_rows([row])

        return read

    return Dataset([_Read([make(f) for f in files])])


def read_numpy(paths, *, column: str = "data") -> Dataset:
    """.npy files, one block per file (reference: ``read_numpy``)."""
    files = _expand(paths)

    def make(task_path):
        def read():
            arr = np.load(task_path, allow_pickle=False)
            return B.block_from_batch({column: arr})

        return read

    return Dataset([_Read([make(f) for f in files])])


# ---- TFRecord framing (no tensorflow dependency) -----------------------
# Each record: u64 length | u32 masked-crc32c(length) | payload |
# u32 masked-crc32c(payload). CRC32C: the crc32c package when present,
# else a plain-int table loop (numpy scalar ops are several times
# slower per byte than Python ints, so the table stays a list).

_CRC32C_TABLE: Optional[list] = None


def _crc32c(data: bytes) -> int:
    try:
        import crc32c as _c  # type: ignore

        return _c.crc32c(data)
    except ImportError:
        pass
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in builtins.range(256):
            c = i
            for _ in builtins.range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def read_tfrecords(paths, *, column: str = "data",
                   verify_crc: bool = True) -> Dataset:
    """TFRecord files -> one row per record with the raw payload bytes
    in ``column`` (reference: ``datasource/tfrecords_datasource.py``;
    the framing is read natively, no tensorflow import)."""
    import struct

    files = _expand(paths)

    def make(task_path):
        def read():
            rows = []
            with open(task_path, "rb") as f:
                while True:
                    head = f.read(12)
                    if len(head) < 12:
                        break
                    (length,), (lcrc,) = (struct.unpack("<Q", head[:8]),
                                          struct.unpack("<I", head[8:]))
                    payload = f.read(length)
                    crc_buf = f.read(4)
                    if len(payload) != length or len(crc_buf) != 4:
                        raise ValueError(
                            f"truncated TFRecord in {task_path}")
                    (pcrc,) = struct.unpack("<I", crc_buf)
                    if verify_crc and (
                            _masked_crc(head[:8]) != lcrc
                            or _masked_crc(payload) != pcrc):
                        raise ValueError(
                            f"corrupt TFRecord in {task_path}")
                    rows.append({column: payload})
            return B.block_from_rows(rows)

        return read

    return Dataset([_Read([make(f) for f in files])])


def _tfrecord_writer(block, fname, column: str = "data"):
    import struct

    rows = B.block_to_rows(block)
    with open(fname, "wb") as f:
        for row in rows:
            payload = row[column]
            if not isinstance(payload, (bytes, bytearray)):
                payload = bytes(payload)
            head = struct.pack("<Q", len(payload))
            f.write(head)
            f.write(struct.pack("<I", _masked_crc(head)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))


def write_tfrecords(ds: Dataset, path: str, *,
                    column: str = "data") -> List[str]:
    """Write ``column`` (bytes per row) as TFRecord files, one per
    block, with valid masked CRCs. Block-parallel."""
    return ds.write_tfrecords(path, column=column)


def read_images(paths, *, include_paths: bool = False,
                size: Optional[tuple] = None) -> Dataset:
    """Image files -> rows with an ``image`` HWC uint8 array
    (reference: ``datasource/image_datasource.py``). Gated on PIL;
    raises a clear ImportError when Pillow is unavailable."""
    try:
        from PIL import Image  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "read_images requires Pillow, which is not installed; use "
            "read_binary_files and decode in map()") from e
    files = _expand(paths)

    def make(task_path):
        def read():
            from PIL import Image

            img = Image.open(task_path).convert("RGB")
            if size is not None:
                img = img.resize(size)
            row = {"image": np.asarray(img, dtype=np.uint8)}
            if include_paths:
                row["path"] = task_path
            return B.block_from_rows([row])

        return read

    return Dataset([_Read([make(f) for f in files])])


def from_pandas(df) -> Dataset:
    """pandas DataFrame -> single-block dataset (gated on pandas)."""
    import pyarrow as pa

    return Dataset([_Read([lambda: pa.Table.from_pandas(df)])])


def from_arrow(table) -> Dataset:
    """pyarrow Table(s) -> dataset, one block per table (reference:
    ``from_arrow``)."""
    tables = table if isinstance(table, (list, tuple)) else [table]
    return Dataset([_Read([(lambda t=t: t) for t in tables])])


def from_torch(torch_dataset, *, num_blocks: int = 1) -> Dataset:
    """torch.utils.data.Dataset (map-style) -> dataset of ``{"item": x}``
    rows (reference: ``from_torch``). Tensors become numpy arrays."""
    n = len(torch_dataset)
    per = -(-n // num_blocks) if n else 1

    def make(lo, hi):
        def read():
            rows = []
            for i in builtins.range(lo, hi):
                item = torch_dataset[i]
                if hasattr(item, "numpy"):
                    item = item.numpy()
                elif isinstance(item, tuple):
                    item = tuple(x.numpy() if hasattr(x, "numpy") else x
                                 for x in item)
                rows.append({"item": item})
            return B.block_from_rows(rows)

        return read

    tasks = [make(i * per, builtins.min((i + 1) * per, n))
             for i in builtins.range(num_blocks) if i * per < n]
    return Dataset([_Read(tasks or [lambda: B.block_from_rows([])])])


def read_sql(sql: str, connection_factory, *,
             parallelism: int = 1) -> Dataset:
    """DBAPI query -> dataset (reference: ``read_sql``). The factory
    returns a NEW connection per read task (connections don't pickle);
    works with sqlite3, psycopg2, or any DBAPI-2 driver. With
    ``parallelism > 1`` the query is sharded by row number modulo N —
    valid for engines supporting the standard ROW_NUMBER() or for
    naturally keyed queries; use 1 when unsure."""
    def make(shard, total):
        def read():
            conn = connection_factory()
            try:
                cur = conn.cursor()
                cur.execute(sql)
                cols = [d[0] for d in cur.description]
                rows = [dict(builtins.zip(cols, r))
                        for i, r in enumerate(cur.fetchall())
                        if i % total == shard]
                return B.block_from_rows(rows)
            finally:
                conn.close()

        return read

    n = builtins.max(1, parallelism)
    return Dataset([_Read([make(s, n) for s in builtins.range(n)])])


def read_webdataset(paths, *, suffixes: Optional[List[str]] = None
                    ) -> Dataset:
    """WebDataset-style tar shards -> one row per sample (reference:
    ``read_webdataset``). Files sharing a basename stem group into one
    row keyed by extension (``{"__key__": stem, "jpg": bytes, ...}``);
    ``suffixes`` filters which extensions load. Pure stdlib tarfile —
    no webdataset dependency."""
    import tarfile

    files = _expand(paths)

    def make(task_path):
        def read():
            samples: Dict[str, Dict[str, Any]] = {}
            order: List[str] = []
            with tarfile.open(task_path) as tf:
                for member in tf:
                    if not member.isfile():
                        continue
                    name = os.path.basename(member.name)
                    stem, _, ext = name.partition(".")
                    if suffixes is not None and ext not in suffixes:
                        continue
                    if stem not in samples:
                        samples[stem] = {"__key__": stem}
                        order.append(stem)
                    samples[stem][ext] = tf.extractfile(member).read()
            return B.block_from_rows([samples[s] for s in order])

        return read

    return Dataset([_Read([make(f) for f in files])])


def _json_writer(block, fname):
    """JSON-lines writer. ndarrays become lists; bytes become base64
    strings (JSON has no binary type)."""
    import base64
    import json as _json

    def enc(v):
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, (bytes, bytearray)):
            return base64.b64encode(bytes(v)).decode("ascii")
        return v

    rows = B.block_to_rows(block)
    with open(fname, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(_json.dumps(
                {k: enc(v) for k, v in row.items()}) + "\n")


def _parquet_writer(block, fname):
    import pyarrow.parquet as pq

    pq.write_table(block, fname)


def _csv_writer(block, fname):
    import pyarrow.csv as pcsv

    pcsv.write_csv(block, fname)


def _numpy_writer(block, fname, column: str):
    batch = B.block_to_batch(block)
    np.save(fname, batch[column])


# Module-level write entry points delegate to the block-parallel Dataset
# methods (one write task per block; reference: Datasink write tasks).

def write_json(ds: Dataset, path: str) -> List[str]:
    return ds.write_json(path)


def write_parquet(ds: Dataset, path: str) -> List[str]:
    return ds.write_parquet(path)


def write_csv(ds: Dataset, path: str) -> List[str]:
    return ds.write_csv(path)
