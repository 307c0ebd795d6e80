"""In-memory dataloader (counterpart of ``hetu_tpu/dataloader.py``).

A ``Dataloader`` walks its numpy data by a cursor, in order or shuffled by
``RandomState(seed)``. The executor uploads a small sequential dataset to
the device once and slices batches there (see ``SubExecutor``); other
loaders hand it one host batch per step. The elastic and GNN loaders arrive
with their slices.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .graph.node import Op


class Dataloader:
    def __init__(self, raw_data, batch_size, name="default", func=None,
                 drop_last=True, shuffle=False, seed=0):
        self.raw_data = np.asarray(raw_data)
        if self.raw_data.dtype == np.float64:
            self.raw_data = self.raw_data.astype(np.float32)
        self.batch_size = int(batch_size)
        self.name = name
        self.func = func
        self.drop_last = drop_last
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._peeked: Optional[np.ndarray] = None
        self.init_states()

    def init_states(self):
        """Epoch start. Sharding by process rank (reference :19-24) arrives
        with the data-parallel slice; one process reads everything."""
        self._data = self.raw_data
        self._order = np.arange(self._data.shape[0])
        n = self._data.shape[0]
        if self.drop_last:
            self.batch_num = n // self.batch_size
        else:
            self.batch_num = int(np.ceil(n / self.batch_size))
        self._cursor = 0

    def _maybe_reshuffle(self):
        if self._cursor == 0 and self.shuffle:
            self._rng.shuffle(self._order)

    def _next_batch(self) -> np.ndarray:
        self._maybe_reshuffle()
        i = self._cursor
        idx = self._order[i * self.batch_size:(i + 1) * self.batch_size]
        batch = self._data[idx]
        if self.func is not None:
            batch = self.func(batch)
        self._cursor = (self._cursor + 1) % self.batch_num
        return batch

    # -- resume support ------------------------------------------------------
    def state_dict(self) -> dict:
        """Epoch position as a flat dict of numpy arrays: cursor, shuffle
        order, MT19937 RNG position, and any peeked-but-unconsumed batch —
        restoring reproduces the exact batch sequence an uninterrupted run
        would have seen."""
        key, pos, has_gauss, cached = self._rng.get_state()[1:5]
        # copy: the epoch-wrap reshuffle mutates _order IN PLACE
        d = {"cursor": np.asarray(self._cursor, np.int64),
             "order": np.array(self._order, copy=True),
             "rng_key": np.asarray(key),
             "rng_pos": np.asarray(pos, np.int64),
             "rng_has_gauss": np.asarray(has_gauss, np.int64),
             "rng_cached_gaussian": np.asarray(cached, np.float64)}
        if self._peeked is not None:
            d["peeked"] = np.asarray(self._peeked)
        return d

    def load_state_dict(self, d: dict) -> None:
        order = np.asarray(d["order"])
        if order.shape != self._order.shape:
            raise ValueError(
                f"dataloader state has {order.shape[0]} samples, this "
                f"loader has {self._order.shape[0]} — restoring onto a "
                "different dataset/sharding would silently skew batches")
        self._order = order.copy()
        self._cursor = int(d["cursor"])
        self._rng.set_state(("MT19937", np.asarray(d["rng_key"], np.uint32),
                             int(d["rng_pos"]), int(d["rng_has_gauss"]),
                             float(d["rng_cached_gaussian"])))
        self._peeked = (np.asarray(d["peeked"]) if "peeked" in d else None)

    def get_arr(self) -> np.ndarray:
        if self._peeked is not None:
            batch, self._peeked = self._peeked, None
            return batch
        return self._next_batch()

    def peek_arr(self) -> np.ndarray:
        """The batch the next ``get_arr`` will return, without consuming
        it: the PS runtime pulls batch N+1's embedding rows while step N
        runs."""
        if self._peeked is None:
            self._peeked = self._next_batch()
        return self._peeked


class DataloaderOp(Op):
    """Graph node multiplexing one Dataloader per subexecutor name
    (reference dataloader.py:134)."""

    is_dataloader = True

    def __init__(self, dataloaders):
        super().__init__([], None)
        self.dataloaders = {d.name: d for d in dataloaders}
        self.name = f"DataloaderOp_{self.id}"

    def get_batch_num(self, name):
        return self.dataloaders[name].batch_num

    def get_batch(self, name):
        return self.dataloaders[name].get_arr()

    def peek_batch(self, name):
        return self.dataloaders[name].peek_arr()

    def compute(self, input_vals, tc):
        raise AssertionError("Dataloader batches are supplied by the executor")


def dataloader_op(dataloaders):
    """Accepts [Dataloader, ...] or [[raw_data, batch_size, name], ...]
    (both forms appear in reference examples)."""
    dls = []
    for d in dataloaders:
        if isinstance(d, Dataloader):
            dls.append(d)
        else:
            dls.append(Dataloader(*d))
    return DataloaderOp(dls)
