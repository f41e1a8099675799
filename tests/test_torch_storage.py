"""The port's checkpoint and table-cache files (tpusim_torch.io.storage)
against tpusim's (tpusim.io.storage): the same content keys and file
names, round trips in both directions, the newest-first ladder, pruning by
retention, the torn-file walk-back and the table cache."""

import os

import numpy as np
import pytest

import tpusim.io.storage as js
import tpusim_torch.io.storage as ps

DIGEST = "ab" * 32


def _arrays(cursor):
    rng = np.random.default_rng(cursor)
    return {"placed": rng.integers(-1, 9, 12).astype(np.int32),
            "masks": rng.random((12, 8)) < 0.3,
            "key": np.asarray([cursor, 2**32 - 1], np.uint32)}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_digest_and_names_match_tpusim(tmp_path):
    chunks = [b"salt", np.arange(7, dtype=np.int32).tobytes(), b""]
    assert ps.checkpoint_digest(chunks) == js.checkpoint_digest(chunks)
    d = str(tmp_path)
    assert ps.checkpoint_path(d, DIGEST, 40) == js.checkpoint_path(d, DIGEST,
                                                                   40)
    assert ps.tables_path(d, DIGEST) == js.tables_path(d, DIGEST)


@pytest.mark.parametrize("writer,reader", [(ps, js), (js, ps), (ps, ps)],
                         ids=["port-to-tpusim", "tpusim-to-port", "port"])
def test_checkpoint_round_trip(tmp_path, writer, reader):
    d = str(tmp_path)
    for c in (10, 30, 20):
        writer.save_checkpoint(d, DIGEST, c, _arrays(c))
    assert [c for c, _ in reader.iter_checkpoints(d, DIGEST)] == [30, 20, 10]
    assert reader.find_checkpoint(d, DIGEST)[0] == 30
    cursor, arrays = reader.load_checkpoint(reader.checkpoint_path(
        d, DIGEST, 20))
    assert cursor == 20
    _same(arrays, _arrays(20))
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


@pytest.mark.parametrize("keep,left", [(0, [30]), (-1, [30, 20, 10]),
                                       (2, [30, 20])])
def test_prune_matches_tpusim(tmp_path, keep, left):
    for mod, sub in ((ps, "port"), (js, "tpusim")):
        d = str(tmp_path / sub)
        for c in (10, 20, 30):
            mod.save_checkpoint(d, DIGEST, c, _arrays(c))
        mod.save_checkpoint(d, "cd" * 32, 5, _arrays(5))  # another run
        mod.prune_checkpoints(d, DIGEST, 30, keep=keep)
        assert [c for c, _ in mod.iter_checkpoints(d, DIGEST)] == left
        assert len(mod.iter_checkpoints(d, "cd" * 32)) == 1
        # the end of a run prunes past its last cursor
        mod.prune_checkpoints(d, DIGEST, 31, keep=keep)
        assert len(mod.iter_checkpoints(d, DIGEST)) == (
            0 if keep == 0 else len(left))


def test_torn_file_walks_back(tmp_path):
    d = str(tmp_path)
    for c in (10, 20):
        ps.save_checkpoint(d, DIGEST, c, _arrays(c))
    torn = ps.checkpoint_path(d, DIGEST, 20)
    with open(torn, "r+b") as f:
        f.truncate(40)
    skipped = []
    cursor, arrays, path = ps.load_valid_checkpoint(
        d, DIGEST, on_skip=lambda p, err: skipped.append(p))
    assert cursor == 10 and skipped == [torn] and not os.path.exists(torn)
    _same(arrays, _arrays(10))
    # a validator's refusal walks back too; max_cursor bounds the search and
    # delete_invalid=False leaves the files alone
    ps.save_checkpoint(d, DIGEST, 20, _arrays(20))

    def refuse(arrays):
        raise ValueError("layout")

    assert ps.load_valid_checkpoint(d, DIGEST, validate=refuse,
                                    delete_invalid=False) is None
    assert len(ps.iter_checkpoints(d, DIGEST)) == 2
    assert ps.load_valid_checkpoint(d, DIGEST, max_cursor=15)[0] == 10
    assert ps.load_valid_checkpoint(d, DIGEST, max_cursor=9) is None


def test_tables_round_trip(tmp_path):
    d = str(tmp_path)
    assert ps.find_tables(d, DIGEST) is None and ps.find_tables("", DIGEST) \
        is None
    tables = {"score_tbl": np.arange(24, dtype=np.int32).reshape(4, 6),
              "feas_tbl": np.ones((2, 6), np.int32)}
    path = ps.save_tables(d, DIGEST, tables)
    assert ps.find_tables(d, DIGEST) == path == js.find_tables(d, DIGEST)
    _same(ps.load_tables(path), tables)
    _same(js.load_tables(path), tables)


def test_file_sha256_and_atomic_write(tmp_path):
    path = str(tmp_path / "sub" / "blob")
    assert ps.write_bytes_atomic(path, b"x" * 3_000_000) == path
    assert ps.file_sha256(path) == js.file_sha256(path)
    ps.write_bytes_atomic(path, b"second")
    assert open(path, "rb").read() == b"second"
    assert os.listdir(tmp_path / "sub") == ["blob"]
