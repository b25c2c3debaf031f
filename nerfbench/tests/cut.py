"""A cell cut to a size the CPU runs in seconds: the published widths,
a small store, batch and sample counts, small frames."""
import copy

from nerfbench import run


def cut_cell(name, root=None, world=2):
    cell = copy.deepcopy(run.load_cell(name) if root is None
                         else run.load_cell(name, root))
    cfg, mix = cell["config"], cell["traffic"]
    cfg["store"]["n_rays"] = 8192
    cfg["render"]["N_samples"] = min(cfg["render"]["N_samples"], 16)
    cfg["render"]["N_importance"] = 16
    if mix["runner"] == "train":
        mix.update(batch_per_rank=64, segment_steps=2, trace_steps=2)
        if mix["world"] > 1:
            mix["world"] = cell["chips"] = world
    else:
        ev = cfg["eval"]
        ev.update(img_wh=[24, 24], chunk=256, N_samples=16, N_importance=16)
        mix.update(warmup_frames=1, trace_frames=2, frames_due=3)
    return cell


def run_cut(name, fault=None, trace=0, seconds=0.5, seed=3000000019,
            cell=None):
    cell = cell if cell is not None else cut_cell(name)
    return run.main(["--workload", name, "--seed", str(seed), "--seconds",
                     str(seconds), "--trace", str(trace)], device="cpu",
                    cell=cell, fault=fault)


def program_batches(group, device, cell, seed):
    """The checked steps' rows and draws as the program's Trainer takes
    them on this rank (a rank function for dist.launch, or called with no
    group): its _sample_batch and step_draws of steps 0 .. k-1, after the
    runner's own set-up of the store."""
    import torch
    from nerfbench.runners import train
    tr = train.trainer_with_store(cell, seed, torch.device(device), group)
    out = []
    for i in range(cell["traffic"]["checked_steps"]):
        batch = tr._sample_batch(i)
        draws = tr.step_draws(seed, i)
        out.append({"rays": batch[0], "rgbs": batch[1],
                    "occm": batch[2] if len(batch) > 2 else None,
                    "draws": {k: v for k, v in vars(draws).items()
                              if v is not None}})
    return {"batches": out, "store": tr.all_rays[:, :6].clone()}
