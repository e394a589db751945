"""Entry adapter of the gather configurations: `sourmash gather` against a
collection held as the port's FlatIndex.

Set-up makes the collection from the seed and holds it as `sourmash
gather` holds a loaded database: a `FlatIndex` over the signatures, its
banks built on the card by the warm-up query. A request is one query
through what `commands.gather` runs after `load_dbs_and_sigs`, each part
in a span of its own:

- `prefetch`: `FlatIndex.counter_gather` on the query's flattened copy, and
  the split of the query into hashes some match holds and the rest;
- `schedule`: `index.flat.schedule_device_gather` over the counter;
- `rows`: the iteration of `search.GatherDatabases`.

Those are the entry points the benchmark calls (a later change keeps them
callable). `correct` compares every row of every query the window finished
(match, intersect_bp, unique_intersect_bp, f_unique_weighted, remaining_bp,
in order) with the numpy greedy gather of `perfbench/reference/gather.py`.
"""

from __future__ import annotations

import os

import numpy as np

from perfbench.lib import traffic
from perfbench.reference import gather as ref


class Session:
    work_unit = "queries"

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, tr = ctx.params("config"), ctx.params("traffic")
        self.cfg, self.tr = cfg, tr
        if ctx.device == "cpu":
            os.environ["SOURMASH_TORCH_DEVICE"] = "cpu"
        from sourmash_tpu_torch import SourmashSignature, minhash_from_arrays, signature_from_arrays
        from sourmash_tpu_torch.index.flat import FlatIndex, schedule_device_gather
        from sourmash_tpu_torch.search import GatherDatabases

        self._schedule = schedule_device_gather
        self._gather_databases = GatherDatabases
        self.scaled = int(cfg["scaled"])
        self.threshold_bp = int(cfg["threshold_bp"])
        with ctx.phase("collection"):
            self.coll = traffic.Collection(cfg, ctx.seed)
        with ctx.phase("queries"):
            self.queries = traffic.gather_queries(tr, self.coll, ctx.seed, int(tr["queries"]) + 1)
        self.results = {}
        # a window of whole cycles sends every query size of the traffic's cycle alike
        self.cycle = int(tr.get("cycle", 1))
        self.index = self.query_sigs = None
        if ctx.program == "control":
            # the control stands in the program's place at the cell's load: its
            # holder index over every query it may be sent is its set-up, as
            # the program's banks are the program's
            with ctx.phase("control_index"):
                qunion = np.unique(np.concatenate([q for q, _, _ in self.queries]))
                self.control_holders = ref.Holders(self.coll.hashes, self.coll.offsets, qunion)
            return
        params = dict(ksize=int(cfg["ksize"]), moltype="DNA", num=0, scaled=self.scaled,
                      seed=42, track_abundance=False)
        with ctx.phase("signatures"):
            # frozen, as a loaded database's signatures are
            sigs = [signature_from_arrays(params, self.coll.genome(i), name=self.coll.names[i],
                                          filename=f"genome_{i}.fa.gz").to_frozen()
                    for i in range(self.coll.n)]
            self.index = FlatIndex(sigs, location=cfg["database"])
            qparams = dict(params, track_abundance=tr.get("abundance") is not None)
            self.query_sigs = [
                SourmashSignature(minhash_from_arrays(qparams, q, ab), name=f"query_{i}",
                                  filename=f"query_{i}.sig").to_frozen()
                for i, (q, ab, _) in enumerate(self.queries)
            ]

    def describe(self) -> str:
        sizes = [len(q) for q, _, _ in self.queries]
        return (f"{self.coll.n} sketches, {len(self.coll.hashes)} hashes; {len(sizes) - 1} "
                f"queries of {min(sizes)}-{max(sizes)} hashes")

    def _gather(self, query) -> list:
        spans = self.ctx.spans
        with spans.span("prefetch"):
            flat = query.copy()
            if flat.minhash.track_abundance:
                with flat.update() as flat:
                    flat.minhash = flat.minhash.flatten()
            noident = flat.minhash.to_mutable()
            ident = noident.copy_and_clear()
            counters = []
            try:
                counter = self.index.counter_gather(flat, self.threshold_bp)
            except ValueError:  # no match above the threshold
                counter = None
            if counter is not None:
                found = counter.union_found
                ident.add_many(found)
                noident.remove_many(found)
                counters.append(counter)
        with spans.span("schedule"):
            if counters:
                self._schedule(counters)
        with spans.span("rows"):
            rows = []
            for r in self._gather_databases(query, counters, threshold_bp=self.threshold_bp,
                                            noident_mh=noident, ident_mh=ident):
                rows.append((r.match.name, int(r.intersect_bp), int(r.unique_intersect_bp),
                             float(r.f_unique_weighted), int(r.remaining_bp)))
        return rows

    def warm(self):
        "The last query, which the window never sends: builds the banks and warms the rounds."
        if self.index is not None:
            self._gather(self.query_sigs[-1])

    def _slot(self, i: int) -> int:
        return i % (len(self.queries) - 1)

    def request(self, i: int) -> float:
        j = self._slot(i)
        if self.ctx.program == "control":
            q, ab, _ = self.queries[j]
            rows = ref.gather(q, ab, self.coll.hashes, self.coll.offsets, self.control_holders,
                              self.threshold_bp, self.scaled, greedy=False)
            self.results[i] = [(self.coll.names[m], *rest) for m, *rest in rows]
        else:
            self.results[i] = self._gather(self.query_sigs[j])
        return 1.0

    def counters(self, completed: int) -> dict:
        "The window's work from its inputs: every collection and query hash read once a query."
        qh = sum(len(self.queries[self._slot(i)][0]) for i in range(completed))
        rows = sum(len(r) for r in self.results.values())
        return {"queries": completed, "collection_hashes": len(self.coll.hashes) * completed,
                "query_hashes": qh, "members": self.coll.n * completed, "rows": rows}

    def close(self):
        "Free the program's state before the reference runs."
        self.index = None
        self.query_sigs = None
        import gc

        gc.collect()
        if self.ctx.device == "cuda":
            import torch

            torch.cuda.empty_cache()

    def check(self, completed: int) -> list:
        """Every row of every query the window finished against the numpy
        greedy gather; a query that never answered counts as unanswered."""
        slots = sorted({self._slot(i) for i in range(completed)})
        if not slots:
            return [("queries_unanswered", 0, 0), ("rows_mismatched", 0, 0)]
        qunion = np.unique(np.concatenate([self.queries[j][0] for j in slots]))
        holders = ref.Holders(self.coll.hashes, self.coll.offsets, qunion)
        want = {}
        for j in slots:
            q, ab, _ = self.queries[j]
            rows = ref.gather(q, ab, self.coll.hashes, self.coll.offsets, holders,
                              self.threshold_bp, self.scaled)
            want[j] = [(self.coll.names[m], *rest) for m, *rest in rows]
        unanswered = mismatched = 0
        for i in range(completed):
            got = self.results.get(i)
            if got is None:
                unanswered += 1
                continue
            exp = want[self._slot(i)]
            mismatched += sum(a != b for a, b in zip(got, exp)) + abs(len(got) - len(exp))
        return [("queries_unanswered", unanswered, 0), ("rows_mismatched", mismatched, 0)]
