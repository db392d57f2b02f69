"""The port's host paths that place, check and store rows, held to their
plain forms bit for bit: the jump hash (the native codec's loop and the
numpy rounds) against the JAX package's placement, the integer
uniqueness test against ``np.unique``, a string dictionary's index built
at its first lookup, and a partition's columns encoded on a thread pool
against the same partition encoded one column after another.

One test function on purpose: a ``-n 6 --dist loadfile`` run queues
files by their number of tests, and a one-test file goes last, leaving
every other file's place in the queue as it was."""

import threading

import numpy as np

from cloudberry_tpu.utils import hashing as JH
from cloudberry_tpu_torch import native
from cloudberry_tpu_torch.catalog.catalog import _all_distinct_ints
from cloudberry_tpu_torch.columnar.dictionary import StringDictionary
from cloudberry_tpu_torch.storage import micropartition as MP
from cloudberry_tpu_torch.types import DType, Field, Schema, SqlType
from cloudberry_tpu_torch.utils import hashing as TH


def _jump_hash_equals_the_jax_package(monkeypatch):
    for n_buckets in (0, 1, 2, 7, 8, 12, 64, 1000):
        rng = np.random.default_rng(n_buckets)
        cols = [rng.integers(-2**62, 2**62, 20_000),
                rng.integers(0, 1000, 20_000)]
        keys = TH.hash_columns_np(cols)
        want = JH.jump_consistent_hash_np(JH.hash_columns_np(cols), n_buckets)
        block = keys[:600].reshape(20, 30)
        block_want = JH.jump_consistent_hash_np(block, n_buckets)
        for native_lib in (True, False):
            with monkeypatch.context() as m:
                if native_lib:
                    assert native.load_native() is not None, \
                        "the native codec built"
                else:   # the numpy rounds: the library reads as missing
                    m.setattr(native, "_lib", None)
                    m.setattr(native, "_tried", True)
                got = TH.jump_consistent_hash_np(keys, n_buckets)
                assert got.dtype == want.dtype and got.shape == want.shape
                assert np.array_equal(got, want), (n_buckets, native_lib)
                # a 2-D key block keeps its shape
                assert np.array_equal(
                    TH.jump_consistent_hash_np(block, n_buckets), block_want)


def _int_cases():
    rng = np.random.default_rng(7)
    cases = [np.array([], np.int64), np.array([5]), np.array([3, 3]),
             np.arange(-128, 128).astype(np.int8),
             np.r_[np.arange(-128, 127), 126].astype(np.int8),
             np.arange(256).astype(np.uint8),
             np.array([2**64 - 1, 2**64 - 2, 2**64 - 1], np.uint64),
             np.array([-2**63, 2**63 - 1], np.int64),
             rng.permutation(100_000), rng.integers(0, 6_000, 5_000)]
    for dt in (np.int16, np.int32, np.int64, np.uint32, np.uint64):
        for span in (50, 300, 2_000, 10**9):
            cases.append((rng.integers(0, span, 400) + 10).astype(dt))
    return cases


def _integer_uniqueness_equals_np_unique():
    for arr in _int_cases():
        assert _all_distinct_ints(arr) == (len(np.unique(arr)) == len(arr)), \
            (arr.dtype, arr[:8])


def _dictionary_index_is_built_at_the_first_lookup():
    d = StringDictionary(["b", "a", "c"])
    assert d._idx is None          # a copy that is only decoded builds none
    assert list(d.decode(np.array([2, 0, -1]))) == ["c", "b", None]
    assert d._idx is None
    assert d.code_of("a") == 1 and d.code_of("z") == -1
    assert d.add("z") == 3 and d.values[-1] == "z"
    codes = d.encode(["c", "q", "z", "q", None])
    assert codes.tolist() == [2, 4, 3, 4, 5]
    assert d.values == ["b", "a", "c", "z", "q", None]
    fresh = StringDictionary(d.values)
    assert fresh.encode(["q", None, "b"]).tolist() == [4, 5, 0]


def _parallel_column_encode_writes_the_same_bytes(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    n = 70_000
    fields = tuple(Field(name, SqlType(t), False) for name, t in (
        ("k", DType.INT64), ("flag", DType.INT32), ("p", DType.FLOAT64),
        ("s", DType.STRING), ("d", DType.DATE)))
    dicts = {"s": StringDictionary(["x", "y", "z"])}
    data = {"k": np.sort(rng.integers(0, 10**9, n)),
            "flag": np.repeat(np.arange(7, dtype=np.int32), n // 7 + 1)[:n],
            "p": rng.normal(size=n),
            "s": rng.integers(0, 3, n).astype(np.int32),
            "d": rng.integers(8000, 10000, n).astype(np.int32)}
    schema = Schema(fields)
    assert n >= MP.PARALLEL_ENCODE_ROWS
    for codec in ("zlib", None):
        par_path = tmp_path / f"par-{codec}.cbmp"
        seq_path = tmp_path / f"seq-{codec}.cbmp"
        par = MP.write_micropartition(str(par_path), data, schema, dicts,
                                      codec=codec)
        with monkeypatch.context() as m:
            m.setattr(MP, "PARALLEL_ENCODE_ROWS", n + 1)
            seq = MP.write_micropartition(str(seq_path), data, schema, dicts,
                                          codec=codec)
        assert par == seq
        assert par_path.read_bytes() == seq_path.read_bytes()
        back = MP.read_columns(str(par_path))
        for name, arr in data.items():
            assert np.array_equal(np.asarray(back[name]), arr)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("cbtpu_torch-encode")]


def test_host_paths_equal_their_plain_forms(tmp_path, monkeypatch):
    _jump_hash_equals_the_jax_package(monkeypatch)
    _integer_uniqueness_equals_np_unique()
    _dictionary_index_is_built_at_the_first_lookup()
    _parallel_column_encode_writes_the_same_bytes(tmp_path, monkeypatch)
