"""Columnar tables — the device-array re-design of the Wisconsin paged storage
engine (mc/wisconsin-src/{table,page,loader}.{h,cpp}).

The reference stores tuples in linked chains of bump-allocated byte pages
(page.h TupleBuffer; table.h:68-253 readNext/atomicReadNext cursors;
nontemporalappend16 NT-store append at table.h:193).  All of that machinery
exists to let multiple threads stream over shared memory; a device program
streams device memory through XLA, so the natural layout is one array per
column.

What survives from the reference, re-expressed:

  * ``page_size`` — rows per logical page.  No longer an allocation unit;
    it is the *work-tiling* unit: ``split`` carves the table into
    page-sized row blocks and deals them round-robin exactly like
    Table::split (table.cpp:238-272), so partitioner/joiner work
    assignment matches the reference's.
  * ``WriteTable.generate`` — the generation bridge (table.cpp:206-233):
    zipf>0 → zipf relation, size==alphabet → pk, else fk, using the
    framework's seeded JAX generators.
  * ``load``/``save`` — '|'-separated text files, the Loader/DataWriter
    analog (loader.cpp; conf 'file:' entries like 016M_build.tbl).
  * ``.npz`` binary persist — the PERSIST_RELATIONS analog
    (mc/src/generator.c:211-224), far faster for big relations.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

from .schema import ColumnType, Schema


@dataclasses.dataclass
class Table:
    """Immutable columnar table: one numpy/JAX array per schema column.

    Numeric columns stay as DEVICE arrays end to end (every needless
    np.asarray of a big column is a device-to-host copy); string columns
    are host numpy.  ``rows`` caps the logical row
    count when columns carry static-shape padding (join outputs are
    materialized at next-pow2 capacity with the invalid tail beyond
    ``rows``).

    ``PageCursor`` equivalents are (start, stop) row blocks from split().
    """

    schema: Schema
    columns: List[np.ndarray]
    page_size: int = 1 << 20   # rows per logical page (conf 'pagesize')
    rows: Optional[int] = None  # logical row count (None = column length)

    @property
    def num_rows(self) -> int:
        if self.rows is not None:
            return self.rows
        return 0 if not self.columns else int(self.columns[0].shape[0])

    def column(self, i: int) -> np.ndarray:
        """1-based column accessor (reference conf attribute/select indices
        are 1-based, e.g. ``jattr: 1``).  Returns the valid prefix when the
        backing array carries capacity padding."""
        c = self.columns[i - 1]
        if self.rows is not None and c.shape[0] != self.rows:
            return c[: self.rows]
        return c

    def key_column(self, jattr: int) -> np.ndarray:
        col = self.column(jattr)
        if self.schema.types[jattr - 1] == ColumnType.STRING:
            raise TypeError("join attribute must be numeric")
        return col

    def split(self, nparts: int) -> List[np.ndarray]:
        """Round-robin page split: page p goes to part p % nparts
        (Table::split, table.cpp:238-272).  Returns per-part row-index
        arrays; on the device these drive gather-based work assignment instead of
        pointer chasing."""
        n = self.num_rows
        pages = [np.arange(s, min(s + self.page_size, n))
                 for s in range(0, n, self.page_size)]
        parts: List[List[np.ndarray]] = [[] for _ in range(nparts)]
        for p, rows in enumerate(pages):
            parts[p % nparts].append(rows)
        return [np.concatenate(b) if b else np.empty((0,), np.int64)
                for b in parts]

    def gather(self, rows: np.ndarray) -> "Table":
        """Row gather — device-side for device columns, host for strings."""
        import jax
        import jax.numpy as jnp
        out = []
        for i in range(len(self.columns)):
            c = self.column(i + 1)
            if isinstance(c, jax.Array):
                out.append(c[jnp.asarray(rows)])
            else:
                out.append(np.asarray(c)[rows])
        return Table(self.schema, out, self.page_size)

    def save(self, path: str, separator: str = "|") -> None:
        """Text .tbl writer (the output: 'test.tbl' conf entry)."""
        if path.endswith(".npz"):
            np.savez(path, *[np.asarray(self.column(i + 1))
                             for i in range(len(self.columns))])
            return
        cols = [np.asarray(self.column(i + 1))
                for i in range(len(self.columns))]
        with open(path, "w") as f:
            for i in range(self.num_rows):
                f.write(separator.join(str(c[i]) for c in cols) + "\n")

    def checksum(self, col: int = 1) -> int:
        """Σ of a numeric column — conservation oracle hook."""
        return int(np.asarray(self.column(col), dtype=np.int64).sum())


class WriteTable(Table):
    """Appendable table (reference WriteTable, table.h:200-253).  Appends
    buffer host-side in chunks; ``finalize`` concatenates once — the bump
    allocator analog without per-tuple work."""

    def __init__(self, schema: Schema, page_size: int = 1 << 20):
        super().__init__(schema, schema.empty_columns(), page_size)
        self._chunks: List[List[np.ndarray]] = []

    def append_batch(self, cols: Sequence[np.ndarray]) -> None:
        """Device arrays pass through untouched (never copied to the host
        and back)."""
        import jax
        if len(cols) != self.schema.columns():
            raise ValueError("column count mismatch")
        self._chunks.append([c if isinstance(c, jax.Array) else np.asarray(c)
                             for c in cols])

    def finalize(self) -> None:
        if not self._chunks:
            return
        if len(self._chunks) == 1 and self.num_rows == 0:
            self.columns = self._chunks[0]       # the generate() fast path
        else:
            self.columns = [
                np.concatenate([np.asarray(self.columns[i])]
                               + [np.asarray(c[i]) for c in self._chunks])
                for i in range(self.schema.columns())]
        self._chunks = []

    # -- generation bridge (table.cpp:206-233) ------------------------------

    def generate(self, relation_size: int, alphabet_size: int,
                 zipf_param: float, seed: int) -> None:
        """WriteTable::generate semantics: zipf when zipf_param>0, pk when
        size==alphabet, fk otherwise (table.cpp:214-227).  Column 1 is the
        key; remaining numeric columns get the 1-based row id (the tuple
        payload / rid convention of mc/src/types.h tuple_t)."""
        from ..data import generators as G
        from ..config import Distribution

        import jax.numpy as jnp

        if zipf_param > 0.0:
            keys = G.zipf_keys(relation_size, alphabet_size, zipf_param, seed)
        elif relation_size == alphabet_size:
            keys = G.pk_keys(relation_size, seed)
        else:
            keys = G.fk_from_pk_keys(relation_size, alphabet_size, seed)
        # Physical storage narrows LONG columns to int32 when the generated
        # value range certifies it (keys <= alphabet, payload rid <= size):
        # the logical schema type stays 'long' (save()/np.asarray upcast),
        # but at the reference-scale 256M-row workload the int64 columns
        # alone would cost 4 GB of device memory — columnar width
        # reduction is the analog of the reference's --enable-
        # key8B narrow-tuple build (mc/configure.ac:43-50, 8B vs 16B
        # tuples).
        i32_ok = max(relation_size, alphabet_size) < (1 << 31)
        cols = []
        for i, t in enumerate(self.schema.types):
            narrow = (jnp.int32 if i32_ok and t != ColumnType.DOUBLE
                      else t.dtype)
            if i == 0:
                cols.append(keys.astype(narrow) if t != ColumnType.STRING
                            else np.asarray(keys).astype(str).astype(object))
            elif t == ColumnType.STRING:
                cols.append(np.arange(1, relation_size + 1).astype(str)
                            .astype(object))
            else:
                cols.append(jnp.arange(1, relation_size + 1, dtype=narrow))
        self.append_batch(cols)
        self.finalize()

    # -- text loader (loader.cpp) -------------------------------------------

    def load(self, path: str, separators: str = "|") -> None:
        """Field-separated text loader (Loader::load, loader.cpp; conf
        'file:'/'path:' entries).  .npz files load binary-fast; integer
        schemas parse through the native parallel loader when built;
        .bz2 files decompress transparently (the reference vendors
        bzip2-1.0.5 for exactly this, mc/wisconsin-src Makefile)."""
        if path.endswith(".bz2"):
            import bz2
            import tempfile
            with bz2.open(path, "rt") as src, \
                    tempfile.NamedTemporaryFile("w", suffix=".tbl",
                                                delete=False) as tmp:
                for chunk in iter(lambda: src.read(1 << 22), ""):
                    tmp.write(chunk)
                name = tmp.name
            try:
                self.load(name, separators)
            finally:
                os.unlink(name)
            return
        if path.endswith(".npz"):
            with np.load(path, allow_pickle=True) as data:
                self.append_batch([data[k] for k in data.files])
            self.finalize()
            return
        if all(t in (ColumnType.INT, ColumnType.LONG, ColumnType.POINTER)
               for t in self.schema.types):
            from ..data import tblio
            mat = tblio.load_tbl(path, self.schema.columns(), separators[0])
            if mat is not None:
                self.append_batch([mat[:, i].astype(t.dtype) for i, t in
                                   enumerate(self.schema.types)])
                self.finalize()
                return
        raw = [[] for _ in range(self.schema.columns())]
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                fields = line.split(separators[0])
                for i in range(self.schema.columns()):
                    raw[i].append(fields[i])
        cols = []
        for i, t in enumerate(self.schema.types):
            if t == ColumnType.STRING:
                cols.append(np.array(raw[i], dtype=object))
            else:
                cols.append(np.array(raw[i], dtype=t.dtype))
        self.append_batch(cols)
        self.finalize()
