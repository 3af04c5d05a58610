"""Training CLI (counterpart of the repository's train.py).

    python -m cfen_vit_tpu_torch.train --dataroot R --name exp \
        --model dec_vit --dataset_mode dec_vit \
        --model_G iid_hlgvit_crs_gd4_cfs_v3 --n_feats 24 --hidden_dim_ratio 4 \
        --sb --gpu_ids 0

`<dataroot>/{hazy,clear,r,s}/` in; `<checkpoints_dir>/<name>/` gets
`<epoch>_net_{G,D_A,D_R,D_S}.pth`, `latest_*`, `<tag>_train_state.pt`,
loss_log.txt (and loss_log.jsonl, each printed step's losses at full
precision) and the web/ snapshots.  The epoch/iteration loop, print,
display and save frequencies, per-epoch LR steps and --continue_train are
train.py's.  `--gpu_ids 0` (the default) trains on cuda:0 and raises
without CUDA; `--gpu_ids -1` on the CPU.

`--trace_dir DIR` traces steps 10 to 15 with torch.profiler, as the JAX
train.py does (utils/profiling.py: DIR/trace.json and key_averages.txt),
each step a span `train step <n>`.  `--verbose` prints
each network's structure and parameter count (utils/netinfo.py).

Data parallel (parallel/mesh.py): under torchrun each process trains on
its shard of every `--batchSize` batch, e.g.

    torchrun --standalone --nproc_per_node 2 -m cfen_vit_tpu_torch.train \
        --mesh_shape 2 --batchSize 8 ...    # --gpu_ids -1: gloo on the CPU

and only rank 0 writes opt.txt, the log, the web page and checkpoints.
"""

from __future__ import annotations

import json
import logging
import os
import time


def main(argv=None) -> dict:
    """Runs the loop; returns what it printed: the losses and the seconds
    of each printed step, and the trainer."""
    from ..config import parse_args, set_precision
    from ..data import create_dataloader
    from ..models.dehazing_model import create_model
    from ..parallel import mesh as M
    from ..utils import Visualizer
    from ..utils.netinfo import print_networks
    from ..utils.profiling import annotate, start_trace, stop_trace, tracing

    lead = int(os.environ.get("RANK", 0)) == 0
    cfg = parse_args(argv, is_train=True, save_opt=lead)
    mesh = M.make_mesh(cfg.mesh_shape, cfg.batchSize)
    device = M.device_for(mesh, cfg.gpu_ids)
    mesh = M.init(mesh, device)
    set_precision(cfg.precision)
    data_loader = create_dataloader(cfg, mesh)
    dataset = data_loader.load_data()
    logging.info("#training images = %d", len(data_loader))

    model = create_model(cfg, device)
    model.setup(cfg)
    visualizer = Visualizer(cfg) if lead else None
    if mesh.launched and lead:
        import torch.distributed as dist
        print(f"data parallel: {mesh.size} rank(s), backend "
              f"{dist.get_backend()}, global batch {cfg.batchSize}")
    if cfg.verbose and lead:
        print_networks(model.networks(), verbose=True)
    total_steps = 0
    log = {"losses": [], "step_seconds": [], "model": model}

    for epoch in range(cfg.epoch_count, cfg.niter + cfg.niter_decay + 1):
        epoch_start_time = time.time()
        iter_data_time = time.time()
        epoch_iter = 0
        for data in dataset:
            iter_start_time = time.time()
            if total_steps % cfg.print_freq == 0:
                t_data = iter_start_time - iter_data_time
            total_steps += cfg.batchSize
            epoch_iter += cfg.batchSize
            if cfg.trace_dir and lead and total_steps == 10 * cfg.batchSize:
                start_trace(cfg.trace_dir)
            with annotate(f"train step {total_steps // cfg.batchSize}"):
                model.set_input(data)
                model.optimize_parameters(cfg)
            if not lead:
                iter_data_time = time.time()
                continue
            visualizer.reset()

            if total_steps % cfg.display_freq == 0:
                save_result = total_steps % cfg.update_html_freq == 0
                visualizer.display_current_results(
                    model.get_current_visuals(), epoch, save_result)

            if total_steps % cfg.print_freq == 0:
                losses = model.get_current_losses()   # waits for the step
                t = (time.time() - iter_start_time) / cfg.batchSize
                visualizer.print_current_losses(epoch, epoch_iter, losses,
                                                t, t_data)
                with open(os.path.join(cfg.checkpoints_dir, cfg.name,
                                       "loss_log.jsonl"), "a") as fh:
                    fh.write(json.dumps({"epoch": epoch, "iters": epoch_iter,
                                         **losses}) + "\n")
                log["losses"].append(losses)
                log["step_seconds"].append(time.time() - iter_start_time)

            if total_steps % cfg.save_latest_freq == 0:
                logging.info("saving the latest model (epoch %d, "
                             "total_steps %d)", epoch, total_steps)
                model.save_networks("latest")
            if tracing() and total_steps == 15 * cfg.batchSize:
                stop_trace()     # after the step's print
            iter_data_time = time.time()

        if epoch % cfg.save_epoch_freq == 0 and lead:
            logging.info("saving the model at the end of epoch %d, iters %d",
                         epoch, total_steps)
            model.save_networks("latest")
            model.save_networks(epoch)

        if lead:
            print(f"End of epoch {epoch} / {cfg.niter + cfg.niter_decay} \t "
                  f"Time Taken: {int(time.time() - epoch_start_time)} sec")
        model.update_learning_rate()
    if tracing():              # the run ended before step 15
        stop_trace()
    return log
