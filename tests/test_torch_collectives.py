"""The collective ledger (``repro_torch.utils.collectives``) against the JAX
package's HLO reader (``repro.utils.hlo``), and the fake world
(``repro_torch.launch.mesh.fake_world``) it counts in for the dry run.

The JAX package reads its collectives out of compiled HLO text; the port
records them where it issues them. The same collectives, the sample of
``tests/test_hlo.py`` (an all-reduce over 16 ranks, an all-gather over 8,
a reduce-scatter over 4 and a collective-permute), issued on fake tensors
over a fake process group of 16 ranks, give the same per-op bytes and the
same summary, exactly.
"""

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.utils.hlo import parse_collectives, summarize_collectives
from repro_torch.launch.mesh import fake_world, production_shape
from repro_torch.utils import collectives as coll
from repro_torch.utils.collectives import CollectiveLedger

# tests/test_hlo.py's sample.
SAMPLE = """
%all-reduce.5 = f32[1,4096,4096]{2,1,0} all-reduce(%x), channel_id=1, replica_groups=[32,16]<=[512], use_global_device_ids=true, to_apply=%add
%ag = bf16[128,1024]{1,0} all-gather(%y), channel_id=2, replica_groups=[4,8]<=[32], dimensions={0}
%rs = f32[16,64]{1,0} reduce-scatter(%z), channel_id=3, replica_groups=[2,4]<=[8], to_apply=%add
%cp = bf16[8,8]{1,0} collective-permute(%w), source_target_pairs={{0,1}}
%done = f32[4]{0} all-reduce-done(%ar)
"""

BYTE_KEYS = ("op", "out_bytes", "operand_bytes", "wire_bytes")


def issue_sample(wide_permute: bool = False):
    """The sample's collectives on fake tensors in a fake world of 16
    ranks, under a ledger: its records (the permute as ``batch_isend_irecv``
    with ``wide_permute``, else ``send`` and ``recv``)."""
    with fake_world((16,), ("w",)) as mesh:
        world, g8, g4 = mesh.get_group("w"), dist.new_group(list(range(8))), \
            dist.new_group(list(range(4)))
        with FakeTensorMode(), CollectiveLedger() as ledger:
            dist.all_reduce(torch.empty((1, 4096, 4096)), group=world)
            y = torch.empty((16, 1024), dtype=torch.bfloat16)
            dist.all_gather([torch.empty_like(y) for _ in range(8)], y, group=g8)
            dist.reduce_scatter_tensor(torch.empty((16, 64)), torch.empty((64, 64)), group=g4)
            w = torch.empty((8, 8), dtype=torch.bfloat16)
            if wide_permute:
                works = dist.batch_isend_irecv([dist.P2POp(dist.isend, w, 1),
                                                dist.P2POp(dist.irecv, torch.empty_like(w), 1)])
                for work in works:
                    work.wait()
            else:
                dist.send(w, dst=1)
                dist.recv(w, src=1)
    return ledger.records


@pytest.mark.parametrize("wide_permute", [False, True], ids=["send_recv", "batch_isend_irecv"])
def test_ledger_bytes_and_summary_equal_the_hlo_reader(wide_permute):
    want = parse_collectives(SAMPLE)
    got = issue_sample(wide_permute)
    assert [{k: r[k] for k in BYTE_KEYS} for r in got] == \
        [{k: r[k] for k in BYTE_KEYS} for r in want]
    assert [r["group_size"] for r in got[:3]] == [r["group_size"] for r in want[:3]] == [16, 8, 4]
    assert coll.summarize_collectives(got) == summarize_collectives(want)


def test_ledger_restores_torch_distributed_and_counts_only_inside():
    saved = {name: getattr(dist, name) for name in coll.WRAPPED}
    with fake_world((2,), ("w",)):
        ledger = CollectiveLedger()
        dist.all_reduce(torch.ones(4))
        with ledger:
            dist.all_reduce(torch.ones(4))
            with pytest.raises(RuntimeError, match="already installed"):
                ledger.__enter__()
        dist.all_reduce(torch.ones(4))
    assert ledger.calls == 1 and ledger.records[0]["group_size"] == 2
    assert all(getattr(dist, name) is fn for name, fn in saved.items())


def test_ledger_records_each_op_by_its_conventions():
    r = coll.record("all-gather", 1600, 16)
    assert (r["operand_bytes"], r["wire_bytes"]) == (100, 1500.0)
    r = coll.record("reduce-scatter", 100, 4)
    assert (r["operand_bytes"], r["wire_bytes"]) == (400, 300.0)
    r = coll.record("all-to-all", 800, 8)
    assert (r["operand_bytes"], r["wire_bytes"]) == (800, 700.0)
    with pytest.raises(ValueError):
        coll.record("broadcast", 8, 2)


def test_a_subclass_times_each_call_through_call():
    seen = []

    class Clock(CollectiveLedger):
        def call(self, fn, args, kwargs):
            seen.append(fn.__name__)
            return super().call(fn, args, kwargs)

    with fake_world((2,), ("w",)), Clock() as clock:
        dist.all_reduce(torch.ones(4))
        dist.all_gather([torch.empty(2), torch.empty(2)], torch.ones(2))
    assert seen == ["all_reduce", "all_gather"] and clock.calls == 2


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_fake_world_plays_one_rank_and_leaves_no_group(multi_pod):
    shape, names = production_shape(multi_pod)
    with fake_world(shape, names, rank=37) as mesh:
        assert dist.get_world_size() == (512 if multi_pod else 256)
        assert dist.get_rank() == 37
        assert tuple(mesh.mesh_dim_names) == names and tuple(mesh.shape) == shape
        assert mesh.get_coordinate()[-1] == 37 % 16
        assert mesh.get_group("model").size() == 16
        with pytest.raises(RuntimeError, match="without a process group"):
            with fake_world((2,), ("w",)):
                pass
    assert not dist.is_initialized()


def test_fsdp_gather_and_its_reduce_scatter_are_recorded_by_their_conventions():
    """FSDP's gather at use (``dist.sharding.gather_at_use``) on a fake
    world of (data, model) = (4, 2): the forward's all-gather over the 4
    data ranks of a (64, 32) leaf cut on dimension 1 and cast to bfloat16,
    and the backward's reduce-scatter of its float32 gradient (the list
    form, ``reduce_scatter``), each one record by the conventions of
    ``utils/collectives.py``: an all-gather's operand is a 4th of its
    result, a reduce-scatter's 4 times its result."""
    from repro_torch.dist.sharding import FsdpShard, P, ShardingRules, fsdp_cut, gather_at_use

    with fake_world((4, 2), ("data", "model")) as mesh:
        rules = ShardingRules(mesh=mesh, batch_axes=("data",), model_axis="model",
                              fsdp_axes=("data",))
        cut = fsdp_cut(P("model", "data"), rules)
        assert cut == (1, "data")
        shard = torch.zeros((64, 8), requires_grad=True)
        with CollectiveLedger() as ledger:
            full = gather_at_use(FsdpShard(shard, *cut, torch.bfloat16), rules)
            assert full.shape == (64, 32) and full.dtype == torch.bfloat16
            full.float().sum().backward()
    assert shard.grad.shape == (64, 8) and shard.grad.dtype == torch.float32
    ag, rs = ledger.records
    assert (ag["op"], ag["group_size"], ag["out_bytes"]) == ("all-gather", 4, 64 * 32 * 2)
    assert (ag["operand_bytes"], ag["wire_bytes"]) == (64 * 8 * 2, 64 * 32 * 2 * 3 / 4)
    assert (rs["op"], rs["group_size"], rs["out_bytes"]) == ("reduce-scatter", 4, 64 * 8 * 4)
    assert (rs["operand_bytes"], rs["wire_bytes"]) == (64 * 32 * 4, 64 * 8 * 4 * 3)
