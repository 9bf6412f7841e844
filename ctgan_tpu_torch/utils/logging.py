"""Metric logging (own copy of ``ctgan_tpu/utils/logging.py``).

``plot(name, value)`` buffers a value, ``tick()`` advances the iteration and
``flush()`` prints the mean of each metric since the last flush, appends it
to ``log.ndjson`` (with ``wall_time``) and replaces ``log.pkl``, a dict of
``{name: {iteration: mean}}``, atomically.  The files are the JAX
package's: either package's ``logged_progress`` reads the other's
``log.pkl``, and a logger reloads the ``log.pkl`` it finds on start, so a
resumed run keeps its history.  ``save_curves`` draws one image per metric
with matplotlib, imported only when asked for.

Unlike the JAX logger, :attr:`records` keeps the rows this process flushed.
A ``quiet`` logger prints and writes nothing (a data-parallel run's ranks
but the first); it keeps ``out_dir`` to name the run's directory.
"""

from __future__ import annotations

import collections
import json
import os
import pickle
import time

import numpy as np

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(self, out_dir: str | None = None, *, save_curves: bool = False,
                 print_std: bool = False, quiet: bool = False):
        self.out_dir, self.quiet = out_dir, quiet
        if out_dir and not quiet:
            os.makedirs(out_dir, exist_ok=True)
        self.save_curves = save_curves
        self.print_std = print_std
        self.records: list[dict] = []
        self._iter = 0
        self._since_flush: dict[str, list] = collections.defaultdict(list)
        self._history: dict[str, dict[int, float]] = collections.defaultdict(dict)
        # log.pkl is rewritten from _history on every flush: without the
        # reload a resumed run would erase the curve before the resume
        if out_dir and not quiet:
            pkl = os.path.join(out_dir, "log.pkl")
            if os.path.exists(pkl):
                try:
                    with open(pkl, "rb") as f:
                        for name, series in pickle.load(f).items():
                            self._history[name].update(series)
                except (OSError, EOFError, pickle.UnpicklingError, AttributeError, TypeError):
                    pass  # unreadable old pickle: start clean
            self._backfill_ndjson()

    def _backfill_ndjson(self) -> None:
        """Rewrite ``log.ndjson`` from the pickle's history when it is
        missing or records fewer iterations.  Rebuilt rows carry
        ``"backfilled": true`` and no ``wall_time``."""
        if not self._history:
            return
        hist_max = max(max(s) for s in self._history.values() if s)
        path = os.path.join(self.out_dir, "log.ndjson")
        nd_max = -1
        if os.path.exists(path):
            try:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            nd_max = max(nd_max, int(json.loads(line)["iteration"]))
            except (OSError, ValueError, KeyError, TypeError):
                nd_max = -1  # corrupt ndjson: rebuild it
        if nd_max >= hist_max:
            return
        iters = sorted({i for s in self._history.values() for i in s})
        with open(path, "w") as f:
            for it in iters:
                row: dict = {"iteration": it, "backfilled": True}
                for name, series in sorted(self._history.items()):
                    if it in series:
                        row[name] = series[it]
                f.write(json.dumps(row) + "\n")
        print(f"backfilled {path} from log.pkl ({len(iters)} rows to "
              f"iteration {hist_max}; ndjson had {nd_max})")

    def plot(self, name: str, value) -> None:
        self._since_flush[name].append(float(np.asarray(value)))

    def tick(self) -> None:
        self._iter += 1

    def set_iteration(self, iteration: int) -> None:
        """Move the counter to a resumed run's iteration."""
        self._iter = int(iteration)

    def flush(self) -> dict:
        """Print, log and return the means since the last flush."""
        prints = []
        # "wall_time": the loop's own metric "time" is seconds per iteration
        record: dict = {"iteration": self._iter, "wall_time": time.time()}
        for name, vals in sorted(self._since_flush.items()):
            mean = float(np.mean(vals))
            record[name] = mean
            if self.print_std and len(vals) > 1:
                prints.append(f"{name}\t{mean:.5f}±{float(np.std(vals)):.5f}")
            else:
                prints.append(f"{name}\t{mean:.5f}")
            self._history[name][self._iter] = mean
        if not self.quiet:
            print(f"iter {self._iter}\t" + "\t".join(prints), flush=True)
        self._since_flush.clear()
        self.records.append(record)

        if self.out_dir and not self.quiet:
            with open(os.path.join(self.out_dir, "log.ndjson"), "a") as f:
                f.write(json.dumps(record) + "\n")
            # atomic: log.pkl is what resume.logged_progress trusts
            pkl_path = os.path.join(self.out_dir, "log.pkl")
            tmp_path = pkl_path + ".tmp"
            with open(tmp_path, "wb") as f:
                pickle.dump(dict(self._history), f)
            os.replace(tmp_path, pkl_path)
            if self.save_curves:
                self._save_curves()
        return record

    def _save_curves(self) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for name, series in self._history.items():
            xs = sorted(series)
            plt.figure(figsize=(6, 4))
            plt.plot(xs, [series[x] for x in xs])
            plt.xlabel("iteration")
            plt.ylabel(name)
            safe = name.replace(" ", "_").replace("/", "_")
            plt.savefig(os.path.join(self.out_dir, f"{safe}.jpg"))
            plt.close()

    @property
    def iteration(self) -> int:
        return self._iter

    @property
    def pending(self) -> bool:
        """Whether values were plotted since the last flush."""
        return bool(self._since_flush)

    def history(self, name: str) -> dict[int, float]:
        return dict(self._history.get(name, {}))
