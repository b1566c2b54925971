"""Blocks: the unit of distributed data (port of ``ray_tpu/data/block.py``;
reference ``python/ray/data/block.py`` — Arrow tables in the object store).

A block is a ``pyarrow.Table``; helpers convert rows (list of dicts) and
batches (dict of numpy arrays) at the operator boundary. Block *refs* flow
through the plan; block payloads live in the object plane. This is the only
module that touches the block type: the rest of Data goes through these
helpers. pyarrow is imported inside each function, so importing the port
does not load it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

import numpy as np


def _pa():
    import pyarrow as pa

    return pa


def block_from_rows(rows: List[Dict[str, Any]]):
    pa = _pa()
    if not rows:
        return pa.table({})
    # Multi-dim ndarray values (images, feature maps) become Arrow
    # fixed-shape tensor columns (reference: Ray's ArrowTensorArray
    # extension) when every row agrees on shape; block_to_rows restores
    # them as ndarrays. Keys are the UNION across rows (missing -> null),
    # matching pa.Table.from_pylist semantics.
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    cols: Dict[str, list] = {k: [r.get(k) for r in rows] for k in keys}
    arrays, names = [], []
    for k, vals in cols.items():
        if (isinstance(vals[0], np.ndarray) and vals[0].ndim >= 2
                and all(isinstance(v, np.ndarray)
                        and v.shape == vals[0].shape for v in vals)):
            arrays.append(pa.FixedShapeTensorArray.from_numpy_ndarray(
                np.stack(vals)))
        else:
            arrays.append(pa.array(vals))
        names.append(k)
    return pa.Table.from_arrays(arrays, names=names)


def block_from_batch(batch: Dict[str, np.ndarray]):
    pa = _pa()
    cols = {}
    for k, v in batch.items():
        arr = np.asarray(v)
        if arr.dtype != object and arr.ndim >= 2:
            # multi-dim numeric columns (token rows, images) become
            # fixed-shape tensor columns: one buffer wrap, not a python
            # list per row
            cols[k] = pa.FixedShapeTensorArray.from_numpy_ndarray(
                np.ascontiguousarray(arr))
        elif arr.dtype == object:
            # ragged / nested columns (lists of token ids): build from
            # the python values — arrow infers a list type
            cols[k] = pa.array(list(v))
        else:
            cols[k] = pa.array(arr)
    return pa.table(cols)


def block_to_rows(block) -> List[Dict[str, Any]]:
    pa = _pa()
    tensor_cols = {}
    for name in block.column_names:
        col = block.column(name)
        if isinstance(col.type, pa.FixedShapeTensorType):
            tensor_cols[name] = col.combine_chunks().to_numpy_ndarray()
            block = block.drop_columns([name])
    if block.num_columns:
        rows = block.to_pylist()
    elif tensor_cols:
        rows = [{} for _ in range(len(next(iter(tensor_cols.values()))))]
    else:  # fully empty block (e.g. a filter dropped every row)
        return []
    for name, arr in tensor_cols.items():
        for i, row in enumerate(rows):
            row[name] = arr[i]
    return rows


def block_to_batch(block) -> Dict[str, np.ndarray]:
    pa = _pa()
    out = {}
    for name, col in zip(block.column_names, block.columns):
        if isinstance(col.type, pa.FixedShapeTensorType):
            out[name] = col.combine_chunks().to_numpy_ndarray()
        else:
            out[name] = np.asarray(col.to_numpy(zero_copy_only=False))
    return out


def block_num_rows(block) -> int:
    return block.num_rows


def block_column_names(block) -> List[str]:
    return list(block.column_names)


def block_size_bytes(block) -> int:
    return block.nbytes


def concat_blocks(blocks: Iterable):
    pa = _pa()
    blocks = [b for b in blocks if b.num_rows > 0]
    if not blocks:
        return pa.table({})
    return pa.concat_tables(blocks, promote_options="default")


def slice_block(block, start: int, length: int):
    return block.slice(start, length)
