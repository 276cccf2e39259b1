"""Multislice layouts in the port, against the JAX package's
``tests/test_multislice.py``.

The reference scales out by slices: traffic inside a slice rides ICI and
traffic across rides DCN. The port keeps its two load-bearing rules:
``MeshConfig.slice_axis_split`` lets only pipeline, data and fsdp cross a
slice boundary (tensor, sequence and expert never), and ranks are placed
slice-major (``slice_major_ranks``, the reference's
``slice_major_devices``), so the C-order reshape puts the slice boundaries
on the slowest axes. A four-rank gloo gang on ``{"data": 2, "tensor": 2}``
over two slices whose ids interleave the ranks is placed slice by slice
and trains as one process does.
"""

import dataclasses
import json
import textwrap

import numpy as np
import pytest
import torch

from tfk8s_tpu.parallel.mesh import MeshConfig as JMeshConfig
from tfk8s_tpu.parallel.mesh import make_mesh, slice_major_devices
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.parallel.mesh import MeshConfig, slice_major_ranks
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.launcher import ProcessContext

from test_torch_distributed import _lines
from test_torch_pipeline import _gang
import _torch_threads  # noqa: F401  (torch's threads under xdist)

RTOL = 1e-5  # a gang against one process, the reference's bound
STEPS = 3

# -- axis split validation -------------------------------------------------------


@pytest.mark.parametrize("axes,slices", [
    ({"data": 2, "fsdp": 2, "tensor": 2}, 2),
    ({"pipeline": 2, "data": 2, "tensor": 2}, 2),
    ({"pipeline": 2, "data": 2, "tensor": 2}, 4),
    ({"data": 8}, 2),
    ({"fsdp": 4, "tensor": 2}, 2),
    ({"data": 2, "tensor": 4}, 1),
])
def test_split_matches_the_reference(axes, slices):
    """The DCN and ICI axes of each layout are the reference's: data or
    pipeline across slices, data straddling them (``data=8`` over two),
    tensor within."""
    got = MeshConfig.from_dict(axes).slice_axis_split(slices)
    assert got == JMeshConfig.from_dict(axes).slice_axis_split(slices)


def test_split_puts_data_on_dcn_and_tensor_on_ici():
    dcn, ici = MeshConfig.create(data=2, fsdp=2, tensor=2).slice_axis_split(2)
    assert dcn == ("data",)
    assert ici == ("fsdp", "tensor")


def test_split_pipeline_over_dcn():
    cfg = MeshConfig.create(pipeline=2, data=2, tensor=2)
    dcn, ici = cfg.slice_axis_split(2)
    assert dcn == ("pipeline",)
    assert set(ici) == {"data", "tensor"}
    dcn4, ici4 = cfg.slice_axis_split(4)
    assert dcn4 == ("pipeline", "data")
    assert ici4 == ("tensor",)


@pytest.mark.parametrize("axes,slices", [({"data": 2, "tensor": 2}, 4), ({"tensor": 8}, 2)])
def test_split_rejects_tensor_across_slices(axes, slices):
    """Tensor across slices, or straddling a boundary, raises the
    reference's ``ValueError`` with its text."""
    with pytest.raises(ValueError, match="tensor") as got:
        MeshConfig.from_dict(axes).slice_axis_split(slices)
    with pytest.raises(ValueError) as want:
        JMeshConfig.from_dict(axes).slice_axis_split(slices)
    assert str(got.value) == str(want.value)


def test_split_rejects_indivisible():
    with pytest.raises(ValueError, match="not divisible"):
        MeshConfig.create(data=2, tensor=3).slice_axis_split(4)


# -- slice-major placement -------------------------------------------------------


@dataclasses.dataclass
class FakeDev:
    id: int
    slice_index: int = None  # type: ignore[assignment]


def test_slice_major_groups_by_slice_id():
    """Ranks that arrive interleaved are placed slice by slice, in the
    reference's device order for the same slice indices."""
    devs = [FakeDev(0, 1), FakeDev(1, 0), FakeDev(2, 1), FakeDev(3, 0),
            FakeDev(4, 0), FakeDev(5, 1), FakeDev(6, 0), FakeDev(7, 1)]
    order = slice_major_ranks([str(d.slice_index) for d in devs], 2)
    assert order == [d.id for d in slice_major_devices(devs, 2)]
    assert order == [1, 3, 4, 6, 0, 2, 5, 7]


def test_slice_major_orders_numeric_ids_as_numbers():
    ids = ["10"] * 2 + ["2"] * 2
    assert slice_major_ranks(ids, 2) == [2, 3, 0, 1]


def test_slice_major_rejects_short_slice():
    with pytest.raises(ValueError, match="need 4 per slice"):
        slice_major_ranks(["0"] * 3 + ["1"] * 5, 2)


def test_slice_major_rejects_too_few_slices():
    with pytest.raises(ValueError, match="spans 1"):
        slice_major_ranks(["0"] * 8, 2)


def test_slice_major_rejects_mixed_ids():
    """Every rank names its slice, or none does."""
    with pytest.raises(ValueError, match="mixes slice-indexed and unindexed"):
        slice_major_ranks(["0", "", "1", "1"], 2)


def test_slice_major_without_ids_takes_contiguous_blocks():
    assert slice_major_ranks([""] * 8, 2) == list(range(8))


def test_multislice_placement_puts_the_boundary_on_the_slow_axis():
    """A 2-slice ``{"data": 2, "fsdp": 2, "tensor": 2}``: the ranks of
    slice 0 sit at data 0 and those of slice 1 at data 1, every ICI axis
    within one slice, as the reference's mesh puts them."""
    cfg = MeshConfig.create(data=2, fsdp=2, tensor=2)
    ids = [str(r % 2) for r in range(8)]  # interleaved
    order = slice_major_ranks(ids, 2)
    for position, rank in enumerate(order):
        assert cfg.coords(position)["data"] == int(ids[rank])
    ref = np.vectorize(lambda d: d.id)(make_mesh(data=2, fsdp=2, tensor=2, num_slices=2).devices)
    assert ref.reshape(-1).tolist() == slice_major_ranks([""] * 8, 2)


def test_launcher_takes_multislice_from_env():
    """The launcher no longer refuses ``TFK8S_NUM_SLICES``: it reads the
    slice count and id for ``build_mesh`` (one process of this eight-device
    layout runs eight ranks, each in its slice); one process of a two-slice
    job without a mesh fails the reference's divisibility check."""
    ctx = ProcessContext.from_env({"TFK8S_MESH": '{"data": 2, "tensor": 4}',
                                   "TFK8S_NUM_SLICES": "2", "TFK8S_SLICE_ID": "s1"})
    assert (ctx.num_slices, ctx.slice_id) == (2, "s1")
    assert ctx.pod_ranks() == 8
    assert ctx.mesh.slice_axis_split(ctx.num_slices) == (("data",), ("tensor",))
    with pytest.raises(ValueError, match="not divisible into 2 slices"):
        ttrain.join_mesh({"TFK8S_DEVICE": "cpu", "TFK8S_NUM_SLICES": "2"})


# -- a gang over two slices ------------------------------------------------------

WORKER = textwrap.dedent(
    """
    import functools, json, os, sys
    sys.path.insert(0, %(repo)r)
    import torch
    from tfk8s_tpu_torch.models import gpt
    from tfk8s_tpu_torch.runtime import train as ttrain

    gpt.tiny_config = functools.partial(gpt.tiny_config, dtype=torch.float32)
    env = dict(os.environ)
    ctx, dev, mesh = ttrain.join_mesh(env)
    print("COORDS " + json.dumps({"rank": ctx.process_id, **mesh.coords}), flush=True)
    task = gpt.task_for_mesh(mesh, cfg=gpt.tiny_config(), seq_len=16, batch_size=4)
    for h in ttrain.run_task(task, env, mesh=mesh):
        print("LOSS %%d %%.17g %%.17g" %% (h["step"], h["loss"], h["grad_norm"]), flush=True)
    """
)
TRAIN_ENV = {"TFK8S_LEARNING_RATE": "1e-2", "TFK8S_INPUT_MODE": "per_host",
             "TFK8S_INPUT_SHARDS": "2", "TFK8S_LOG_EVERY": "1", "TFK8S_TRAIN_STEPS": str(STEPS)}


def test_two_slice_gang_is_placed_slice_major_and_equals_one_process(tmp_path):
    """Ranks 0 and 2 in slice "1", ranks 1 and 3 in slice "0": slice "0"
    comes first, so ranks 1, 3 hold data 0 and ranks 0, 2 data 1, each
    slice's two ranks one tensor group; GPT trains as one process does."""
    slices = [{"TFK8S_SLICE_ID": str(1 - r % 2)} for r in range(4)]
    outs = _gang(str(tmp_path), 4, '{"data": 2, "tensor": 2}',
                 dict(TRAIN_ENV, TFK8S_NUM_SLICES="2"), rank_env=slices, script=WORKER)
    coords = sorted((json.loads(line[7:]) for out in outs for line in _lines(out, "COORDS")),
                    key=lambda c: c["rank"])
    assert [(c["data"], c["tensor"]) for c in coords] == [(1, 0), (0, 0), (1, 1), (0, 1)]
    cfg = tgpt.tiny_config(dtype=torch.float32)
    task = tgpt.task_for_mesh(torch.device("cpu"), cfg=cfg, seq_len=16, batch_size=4)
    want = [(h["loss"], h["grad_norm"])
            for h in ttrain.run_task(task, dict(TRAIN_ENV, TFK8S_DEVICE="cpu"))]
    for out in outs:
        got = [tuple(float(x) for x in line.split()[2:]) for line in _lines(out, "LOSS")]
        np.testing.assert_allclose(got, want, rtol=RTOL)
