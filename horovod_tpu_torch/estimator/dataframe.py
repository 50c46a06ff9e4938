"""DataFrame -> Store materialization (counterpart of
``horovod_tpu/estimator/dataframe.py``; reference
``horovod/spark/common/util.py:360-608``, ``prepare_data``): a
DataFrame's feature and label columns are assembled into dense arrays,
optionally shuffled, then sharded into the Store, where each training
rank reads only its part.  The reference materializes Spark DataFrames
to Parquet through Petastorm; here the input is a **pandas** DataFrame
(or a pyspark one, collected or streamed to pandas), written as the
Store's npz shards.  pandas is imported only when a DataFrame arrives:
``fit(x, y)`` with arrays never needs it.  Two ingest modes:

* ``rows_per_chunk=None``: one shot.  The frame is assembled whole
  (pyspark input through ``toPandas()`` first) and striped into one
  ``part.{rank}.npz`` per rank.
* ``rows_per_chunk=N``: **streaming**.  The frame is consumed in bounded
  chunks of N rows (pyspark input through ``toLocalIterator()``, so the
  driver never holds the whole dataset), each chunk striped across the
  ranks and appended as ``part.{rank}.c{i}.npz``; a ``manifest.json``
  records the chunk counts for the rank-side reader.  The driver's peak
  memory is O(rows_per_chunk), not O(dataset).  ``shuffle`` permutes
  within each chunk only (a bounded-memory approximation, like the
  row-group shuffle of the reference's Petastorm path).

Columns (reference ``util.py:431-480``, the feature assembly):

* numeric scalar columns are concatenated along the last axis in the
  order given: k scalar feature columns become an (n, k) matrix;
* a column whose cells are fixed-shape sequences or arrays (images, say)
  keeps its native shape, and must then be the only feature column (the
  reference has the same single-tensor restriction);
* a single label column keeps its native dtype (integer labels stay
  integers for the cross-entropy losses).
"""

from __future__ import annotations

import numpy as np


def _is_pyspark_df(df) -> bool:
    mod = type(df).__module__ or ""
    return mod.startswith("pyspark.")


def _to_pandas(df):
    if _is_pyspark_df(df):
        return df.toPandas()
    return df


def _column_array(df, col: str) -> np.ndarray:
    """One column → dense array (n, *cell_shape)."""
    if col not in df.columns:
        raise KeyError(
            f"column {col!r} not in DataFrame (has: {list(df.columns)})")
    values = df[col].to_numpy()
    if values.dtype == object:
        # cells are sequences (lists/arrays): must agree on shape
        try:
            return np.stack([np.asarray(v) for v in values])
        except ValueError as exc:
            raise ValueError(
                f"column {col!r} holds ragged sequences; materialization "
                f"needs fixed-shape cells ({exc})") from None
    return values


def assemble_columns(df, cols: list[str]) -> np.ndarray:
    """Feature assembly (reference ``util.py:431-480``): scalar columns
    concatenate along the last axis; a tensor column must stand alone."""
    arrays = [_column_array(df, c) for c in cols]
    if len(arrays) == 1:
        return arrays[0]
    for c, a in zip(cols, arrays):
        if a.ndim != 1:
            raise ValueError(
                f"column {c!r} is non-scalar (shape {a.shape[1:]} per "
                "cell); a tensor column must be the only feature column")
    return np.stack(arrays, axis=1)


def _iter_chunks(df, rows_per_chunk: int):
    """Yield pandas sub-frames of at most ``rows_per_chunk`` rows.
    pyspark input streams through ``toLocalIterator()`` — the driver
    holds one chunk at a time, never the whole dataset (the reference
    achieves the same by having Spark executors write Parquet,
    ``util.py:360-608``)."""
    if _is_pyspark_df(df):
        import pandas as pd

        rows = []
        for row in df.toLocalIterator():
            rows.append(row.asDict())
            if len(rows) == rows_per_chunk:
                yield pd.DataFrame(rows)
                rows = []
        if rows:
            yield pd.DataFrame(rows)
    else:
        for lo in range(0, len(df), rows_per_chunk):
            yield df.iloc[lo:lo + rows_per_chunk]


def materialize_dataframe(store, path: str, df, feature_cols: list[str],
                          label_cols: list[str], num_proc: int,
                          shuffle: bool = False, seed: int = 0,
                          rows_per_chunk: int | None = None) -> dict:
    """Shard ``df``'s features/labels into ``store`` at ``path`` — one
    ``part.{rank}.npz`` per rank, or the chunked streaming layout when
    ``rows_per_chunk`` is set (see module docstring).  Returns the
    dataset metadata the reference computes in
    ``get_simple_meta_from_parquet`` (``util.py:387-421``)."""
    if not feature_cols or not label_cols:
        raise ValueError("feature_cols and label_cols are required for "
                         "DataFrame materialization")
    feature_cols, label_cols = list(feature_cols), list(label_cols)
    if rows_per_chunk is None:
        df = _to_pandas(df)
        x = assemble_columns(df, feature_cols)
        y = assemble_columns(df, label_cols)
        if len(x) == 0:
            raise ValueError("no rows found in the DataFrame "
                             "(reference _get_dataset_info raises the same)")
        if shuffle:
            perm = np.random.RandomState(seed).permutation(len(x))
            x, y = x[perm], y[perm]
        # one shard-layout contract: the striping/naming lives in
        # _shard_to_store, which the array fit() path also uses
        from horovod_tpu_torch.estimator.estimator import _shard_to_store

        _shard_to_store(store, path, x, y, num_proc)
        total_bytes = x.nbytes + y.nbytes
        rows = len(x)
        schema_src = df
    else:
        from horovod_tpu_torch.estimator.estimator import _npz_bytes

        if rows_per_chunk < num_proc:
            raise ValueError(
                f"rows_per_chunk ({rows_per_chunk}) must be >= num_proc "
                f"({num_proc}) so every chunk feeds every rank")
        prng = np.random.RandomState(seed)
        chunk_counts = [0] * num_proc
        rows = 0
        total_bytes = 0
        schema_src = None
        store.make_dir(path)
        for chunk in _iter_chunks(df, rows_per_chunk):
            cx = assemble_columns(chunk, feature_cols)
            cy = assemble_columns(chunk, label_cols)
            if shuffle:
                perm = prng.permutation(len(cx))
                cx, cy = cx[perm], cy[perm]
            for r in range(num_proc):
                sx, sy = cx[r::num_proc], cy[r::num_proc]
                if len(sx) == 0:
                    continue
                store.write_bytes(
                    f"{path}/part.{r}.c{chunk_counts[r]}.npz",
                    _npz_bytes(x=sx, y=sy))
                chunk_counts[r] += 1
            rows += len(cx)
            total_bytes += cx.nbytes + cy.nbytes
            if schema_src is None:
                schema_src = chunk
        if rows == 0:
            raise ValueError("no rows found in the DataFrame "
                             "(reference _get_dataset_info raises the same)")
        if any(c == 0 for c in chunk_counts):
            # fail on the driver, before ranks launch — a rank raising
            # in _load_shard while its peers enter collectives would
            # hang the job instead
            raise ValueError(
                f"dataset ({rows} rows) too small to feed all "
                f"{num_proc} ranks; reduce num_proc")
        import json

        store.write_bytes(f"{path}/manifest.json", json.dumps(
            {"format": "chunked-npz",
             "chunks_per_rank": chunk_counts}).encode())
    return {
        "train_rows": int(rows),
        "total_byte_size": int(total_bytes),
        "avg_row_size": float(total_bytes / rows),
        "schema": {c: str(schema_src[c].dtype) for c in
                   feature_cols + label_cols},
    }
