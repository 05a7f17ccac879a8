"""The port's grid of ranks and its host-side helpers against the JAX package's mesh.

The grid's checks and messages are JAX's ``make_mesh``/``auto_mesh``, on
the cases of tests/test_mesh.py (8 devices there, 8 ranks here), with one
divergence kept on purpose: a grid that leaves ranks out (JAX's sub-mesh)
is refused, since every launched rank runs the loop. The reader's equal
shards are JAX's, file for file. Under two gloo ranks
(``tests/torch_parallel_workers.py``), ``build_batch`` on a loader thread
pads both ranks' batches to the larger time and label widths, and the
host row gather puts the data ranks' rows in order.
"""

import numpy as np
import pytest

from speecht_tpu.data import reader as jreader
from speecht_tpu.parallel import mesh as jmesh
from speecht_tpu_torch.data import reader
from speecht_tpu_torch.parallel import mesh as pmesh

import torch_parallel_workers as workers


def _jax(fn):
    try:
        mesh = fn()
    except ValueError as e:
        return str(e)
    return (mesh.shape["data"], mesh.shape["model"])


def _port(fn):
    try:
        return fn()
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("dp,mp", [(0, 1), (2, 4), (0, 3), (8, 2), (1, 8), (4, 2)])
def test_grid_matches_jax_make_mesh(dp, mp):
    want = _jax(lambda: jmesh.make_mesh(data_parallel=dp, model_parallel=mp))
    assert _port(lambda: pmesh.grid_shape(dp, mp, n=8)) == want


@pytest.mark.parametrize("batch,dp,mp", [(64, 0, 1), (64, 2, 4), (16, 0, 2), (8, 0, 8)])
def test_auto_grid_matches_jax_auto_mesh(batch, dp, mp):
    want = _jax(lambda: jmesh.auto_mesh(batch_size=batch, data_parallel=dp,
                                        model_parallel=mp))
    assert _port(lambda: pmesh.auto_grid_shape(batch, dp, mp, n=8)) == want


@pytest.mark.parametrize("batch,dp,mp", [(1, 0, 1), (12, 0, 1), (6, 0, 2), (64, 2, 3)])
def test_sub_grids_are_refused_where_jax_takes_a_sub_mesh(batch, dp, mp):
    jax_shape = jmesh.auto_mesh(batch_size=batch, data_parallel=dp, model_parallel=mp).shape
    assert jax_shape["data"] * jax_shape["model"] < 8
    with pytest.raises(ValueError, match=f"of 8 ranks out"):
        pmesh.auto_grid_shape(batch, dp, mp, n=8)


def test_one_process_mesh_is_the_identity():
    mesh = pmesh.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.primary
    assert pmesh.sync_bucket_dims(768, 96) == (768, 96)
    x = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(pmesh.allgather_host_rows(x, mesh), x)
    with pytest.raises(ValueError, match="exceeds 1 available devices"):
        pmesh.make_mesh(data_parallel=2)


def test_equal_shard_matches_jax():
    for n in range(13):
        files = list(range(n))
        for count in range(1, 5):
            for index in range(count):
                assert reader._equal_shard(files, index, count) == (
                    jreader._equal_shard(files, index, count))


def test_reader_shards_match_jax(tmp_path):
    cache = tmp_path / "preprocessed-power" / "train"
    cache.mkdir(parents=True)
    for i in range(11):
        np.savez(cache / f"utt-{i}.npz",
                 audio_fragments=np.full((4, 8), i, np.float32),
                 transcript=np.array([i], np.int32))

    def ids(module, shard):
        r = module.SpeechCorpusReader(str(tmp_path))
        return [int(t[0]) for _f, t in r.load_samples(
            "train", feature_type="power", shard_index=shard, shard_count=4)]

    shards = [ids(reader, s) for s in range(4)]
    assert shards == [ids(jreader, s) for s in range(4)]
    assert [len(s) for s in shards] == [2, 2, 2, 2]
    assert len(set(sum(shards, []))) == 8


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    work = tmp_path_factory.mktemp("sync")
    workers.run_ranks(workers.sync_dims, work)
    return [dict(np.load(work / f"sync-{r}.npz")) for r in range(2)]


def test_sync_bucket_dims_under_two_ranks(synced):
    for r in synced:
        # 100 and 600 frames: both ranks pad to 768; labels to 768 // 4
        assert tuple(r["features_shape"]) == (1, 768, 8)
        assert tuple(r["labels_shape"]) == (1, 192)
        assert tuple(r["dims"]) == (20, 7)
        np.testing.assert_array_equal(r["gathered"], [[0] * 3] * 2 + [[1] * 3] * 2)
    np.testing.assert_array_equal(synced[1]["local"], [[1] * 3] * 2)


EXIT_PROBE = """
import atexit
import torch.distributed as dist
# registered first, so it runs after the handlers registered later
atexit.register(lambda: print("initialized at exit:", dist.is_initialized(), flush=True))
from speecht_tpu_torch.parallel import mesh
assert mesh.init_distributed("cpu")
dist.barrier()
"""


def test_joined_group_is_destroyed_before_the_interpreter_exits():
    """A group ``init_distributed`` joins from the launcher's environment
    is destroyed by an exit handler: left to the interpreter's teardown,
    gloo's threads aborted ranks of the multi-process drill after runs
    that succeeded ("terminate called without an active exception")."""
    import os
    import subprocess
    import sys

    from speecht_tpu_torch.tools.multiprocess_drill import free_port

    port = str(free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", EXIT_PROBE],
            env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                     LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                     OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
        assert "initialized at exit: False" in out, out
