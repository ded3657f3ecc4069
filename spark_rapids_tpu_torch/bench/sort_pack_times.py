"""Time K1 (``sort_permutation``) and K15a (``mesh_pack``) of whichever
``spark_rapids_tpu_torch`` is importable, at the shapes ``chip_smoke.py``
checks them: q1's two one-letter keys at 2^24 rows, the mixed
int64/f64/int32/W16-string keys at 2^22 rows in two orders, q6's rank
join (K6 over 56,920 item rows of a W 16 category key, and K1 alone on
that key), and a
4,194,304-row shard of one and of three int32 columns packed into 8
sections in K10's order (top_customers_mesh's and q6_mesh_partitioned's
largest).  Each result is first held against the package's plain version.

Prints one JSON line: the card (``nvidia-smi`` name and power limit), the
package's directory and each time in ms (CUDA events, the mean of 20 calls
after a warm-up, the best of two rounds), beside torch.argsort(stable=True)
of q1's packed key and index_select of every leaf, timed in the same
rounds.  Needs a CUDA card.  Two trees compare on one card, one process
each, in turns (the parent unpacked with ``git archive`` into a git-ignored
directory):

    for t in PARENT . . PARENT; do
        PYTHONPATH=$t python3 spark_rapids_tpu_torch/bench/sort_pack_times.py
    done
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def _time_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _best(torch, fns: dict) -> dict:
    """{name: ms}: the best of two rounds, the functions in turns."""
    times = {k: [] for k in fns}
    for _ in range(2):
        for k, fn in fns.items():
            times[k].append(_time_ms(torch, fn))
    return {k: min(v) for k, v in times.items()}


def _q1_keys(torch, dev, n: int):
    """l_returnflag and l_linestatus as q1's scan gives them: W 4 byte
    matrices, one letter each, all valid."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    cols = []
    for letters in (b"RAN", b"FO"):
        lut = torch.tensor(list(letters), dtype=torch.uint8, device=dev)
        m = torch.zeros((n, 4), dtype=torch.uint8, device=dev)
        m[:, 0] = lut[torch.randint(0, len(letters), (n,), generator=g,
                                    device=dev)]
        cols.append(DeviceColumn(m, torch.ones(n, dtype=torch.bool,
                                               device=dev), T.StringType(),
                                 torch.ones(n, dtype=torch.int32,
                                            device=dev)))
    return ColumnBatch(cols, n, None, dev)


def _mixed_keys(torch, dev, n: int):
    """int64, f64 (NaN, -0.0, nulls), int32 and a W 16 string (nulls)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    g = torch.Generator(device=dev)
    g.manual_seed(2)

    def ints(lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=dtype)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    vals = torch.tensor([-1.5, -0.0, 0.0, 2.25, float("nan"), 7.0, -3e300],
                        dtype=torch.float64, device=dev)
    v_f = torch.rand(n, generator=g, device=dev) > 0.05
    v_s = torch.rand(n, generator=g, device=dev) > 0.05
    f64 = torch.where(v_f, vals[ints(0, len(vals))], 0.0)
    lens = torch.where(v_s, ints(0, 13, torch.int32), 0)
    mat = torch.randint(97, 100, (n, 16), generator=g, device=dev,
                        dtype=torch.uint8)
    mat[torch.arange(16, device=dev)[None, :] >= lens[:, None]] = 0
    cols = [DeviceColumn(ints(-50, 50) * (1 << 40), ones, T.LongType()),
            DeviceColumn(f64, v_f, T.DoubleType()),
            DeviceColumn(ints(-3, 3, torch.int32), ones, T.IntegerType()),
            DeviceColumn(mat, v_s, T.StringType(), lens)]
    return ColumnBatch(cols, n, None, dev)


def _category_keys(torch, dev, n: int):
    """q6's rank join: n item rows of a nullable W 16 string key (10
    category names) against the 11 category groups (the first null)."""
    import numpy as np
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    names = [b"Books", b"Children", b"Electronics", b"Home", b"Jewelry",
             b"Men", b"Music", b"Shoes", b"Sports", b"Women"]
    rng = np.random.default_rng(4)

    def batch(words, valid):
        m = np.zeros((len(words), 16), np.uint8)
        for i, w in enumerate(words):
            m[i, :len(w)] = np.frombuffer(w, np.uint8)
        lens = np.array([len(w) for w in words], np.int32)
        col = DeviceColumn(torch.from_numpy(m).to(dev),
                           torch.from_numpy(valid).to(dev), T.StringType(),
                           torch.from_numpy(lens).to(dev))
        return ColumnBatch([col], len(words), None, dev)
    item = batch([names[i] for i in rng.integers(0, 10, n)],
                 rng.random(n) >= 0.005)
    cats = batch([b""] + names, np.arange(11) > 0)
    return item, cats


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sort_pack_times: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    import spark_rapids_tpu_torch as pkg
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops import partition as PT
    from spark_rapids_tpu_torch.ops import sort as S
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    native.build(["sort", "mesh_exchange", "partition_group"])
    dev = torch.device("cuda", 0)
    out = {"card": card, "package": os.path.dirname(pkg.__file__)}
    q1 = _q1_keys(torch, dev, 1 << 24)
    orders = [S.SortOrder(0, True, True), S.SortOrder(1, True, True)]
    if not torch.equal(S.sort_permutation(q1, orders),
                       S.sort_permutation_plain(q1, orders)):
        raise AssertionError("K1 differs from its plain version (q1 keys)")
    packed = (q1.columns[0].data[:, 0].to(torch.int64) << 8) \
        | q1.columns[1].data[:, 0].to(torch.int64)
    t = _best(torch, {
        "k1_q1_ms": lambda: S.sort_permutation(q1, orders),
        "argsort_ms": lambda: torch.argsort(packed, stable=True)})
    out.update(t)
    del q1, packed
    mixed = _mixed_keys(torch, dev, 1 << 22)
    out["k1_mixed_ms"] = []
    for mo in ([S.SortOrder(1, True, None), S.SortOrder(3, False, None),
                S.SortOrder(0, True, False)],
               [S.SortOrder(3, True, False), S.SortOrder(2, False, True),
                S.SortOrder(1, False, True)]):
        if not torch.equal(S.sort_permutation(mixed, mo),
                           S.sort_permutation_plain(mixed, mo)):
            raise AssertionError("K1 differs from its plain version "
                                 "(mixed keys)")
        out["k1_mixed_ms"].append(_best(torch, {
            "k": lambda: S.sort_permutation(mixed, mo)})["k"])
    del mixed
    from spark_rapids_tpu_torch.ops import join as J
    item, cats = _category_keys(torch, dev, 56_920)
    one = [S.SortOrder(0, True, False)]
    if not torch.equal(S.sort_permutation(item, one),
                       S.sort_permutation_plain(item, one)):
        raise AssertionError("K1 differs from its plain version (q6's "
                             "category key)")
    t = _best(torch, {
        "k1_category_ms": lambda: S.sort_permutation(item, one),
        "k6_q6_ms": lambda: J._key_ids(item, cats, [0], [0])})
    out.update(t)
    n = 4_194_304
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    ids = torch.randint(0, 8, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    perm, counts = PT.partition_order(ids, 8)[:2]
    counts = [int(c) for c in counts.tolist()]
    idx = perm.long()
    for ncols in (1, 3):
        cols = [DeviceColumn(
            torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g,
                          device=dev, dtype=torch.int32),
            torch.rand(n, generator=g, device=dev) < 0.9, T.IntegerType())
            for _ in range(ncols)]
        buf, _layout = ME.mesh_pack(cols, perm, counts)
        if not torch.equal(buf, ME.mesh_pack_plain(cols, perm, counts)):
            raise AssertionError("K15a differs from its plain version")
        leaves = [t for c in cols for t in (c.data, c.validity)]
        t = _best(torch, {
            "k15a": lambda: ME.mesh_pack(cols, perm, counts),
            "index_select": lambda: [torch.index_select(x, 0, idx)
                                     for x in leaves]})
        out[f"k15a_{ncols}col_ms"] = t["k15a"]
        out[f"index_select_{ncols}col_ms"] = t["index_select"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
