"""The benchmark's own account of the program's inputs against the
program's: the rows that set_data, tighten_store and _sample_batch give
the checked steps, and the draws of Trainer.step_draws, on one rank and
on each of two gloo ranks. The reference works these out again
(nerfbench/inputs.py, runners/train.py::reference_batches); a change to
the program's shuffle, shard, packing or draw order fails here by name,
not as a cell that is no longer correct."""
import pytest
import torch

from nerfbench import inputs
from nerfbench.runners import train
from nerfbench.tests.cut import cut_cell, program_batches

SEED = 3000000077


def _split(ref, world, d):
    """Data index d's part of a global batch."""
    b = ref.shape[0] // world
    return ref[d * b:(d + 1) * b]


@pytest.mark.parametrize("name", ["blender_dense.train",
                                  "blender_culled32.train",
                                  "blender_dense.train_dp4"])
def test_program_takes_the_rows_and_draws_the_reference_works_out(name):
    cell = cut_cell(name)
    mix, cfg = cell["traffic"], cell["config"]
    world = mix["world"]
    if world == 1:
        ranks = [program_batches(None, "cpu", cell, SEED)]
    else:
        from nerf_pl_tpu_torch import dist as pdist
        ranks = pdist.launch(program_batches, world, cell, SEED,
                             device="cpu", timeout=240)
    dev = torch.device("cpu")
    refs = train.reference_batches(cell, SEED, dev)
    n = cfg["store"]["n_rays"]
    order, n_local = inputs.store_order(n, SEED, mix["batch_per_rank"]
                                        * world, world)
    rays, _ = inputs.make_store(n, SEED, dev)
    c = cfg.get("culled")
    for d, got in enumerate(ranks):
        if not c:    # the shard as set_data lays it out
            shard = torch.as_tensor(order[d * n_local:(d + 1) * n_local])
            assert torch.equal(got["store"], rays[shard][:, :6])
        for i, (p, r) in enumerate(zip(got["batches"], refs)):
            assert torch.equal(p["rays"][:, :6],
                               _split(r["rays"], world, d)[:, :6]), (d, i)
            assert torch.equal(p["rgbs"], _split(r["rgbs"], world, d))
            torch.testing.assert_close(p["rays"][:, 6:],
                                       _split(r["rays"], world, d)[:, 6:],
                                       rtol=0, atol=1e-5)
            if c:
                bits = _split(r["bits"], world, d).long()
                occm = (bits << torch.arange(c["n_seg"])).sum(-1)
                assert torch.equal(p["occm"], occm), (d, i)
            assert set(p["draws"]) == set(r["draws"])
            for k, v in p["draws"].items():
                assert torch.equal(v, _split(r["draws"][k], world, d)), \
                    (d, i, k)
