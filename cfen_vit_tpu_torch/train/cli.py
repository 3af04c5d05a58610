"""Training CLI (counterpart of the repository's train.py).

    python -m cfen_vit_tpu_torch.train --dataroot R --name exp \
        --model dec_vit --dataset_mode dec_vit \
        --model_G iid_hlgvit_crs_gd4_cfs_v3 --n_feats 24 --hidden_dim_ratio 4 \
        --sb --gpu_ids 0

`<dataroot>/{hazy,clear,r,s}/` in; `<checkpoints_dir>/<name>/` gets
`<epoch>_net_{G,D_A,D_R,D_S}.pth`, `latest_*`, `<tag>_train_state.pt`,
loss_log.txt and the web/ snapshots.  The epoch/iteration loop, print,
display and save frequencies, per-epoch LR steps and --continue_train are
train.py's.  `--gpu_ids 0` (the default) trains on cuda:0 and raises
without CUDA; `--gpu_ids -1` on the CPU.
"""

from __future__ import annotations

import logging
import time


def main(argv=None) -> dict:
    """Runs the loop; returns what it printed: the losses and the seconds
    of each printed step, and the trainer."""
    from ..config import parse_args, select_device, set_precision
    from ..data import create_dataloader
    from ..models.dehazing_model import create_model
    from ..utils import Visualizer

    cfg = parse_args(argv, is_train=True)
    if cfg.trace_dir:
        raise NotImplementedError("--trace_dir is not ported yet (ROADMAP "
                                  "Queue A item 11)")
    device = select_device(cfg.gpu_ids)
    set_precision(cfg.precision)
    data_loader = create_dataloader(cfg)
    dataset = data_loader.load_data()
    logging.info("#training images = %d", len(data_loader))

    model = create_model(cfg, device)
    model.setup(cfg)
    visualizer = Visualizer(cfg)
    if cfg.verbose:
        for name, net in (("G", model.g), *((f"D_{k}", d) for k, d in
                                             model.d.items())):
            n = sum(p.numel() for p in net.parameters())
            print(f"[Network {name}] Total number of parameters : "
                  f"{n / 1e6:.3f} M")
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
            visualizer.reset()
            total_steps += cfg.batchSize
            epoch_iter += cfg.batchSize
            model.set_input(data)
            model.optimize_parameters(cfg)

            if total_steps % cfg.display_freq == 0:
                save_result = total_steps % cfg.update_html_freq == 0
                visualizer.display_current_results(
                    model.get_current_visuals(), epoch, save_result)

            if total_steps % cfg.print_freq == 0:
                losses = model.get_current_losses()   # waits for the step
                t = (time.time() - iter_start_time) / cfg.batchSize
                visualizer.print_current_losses(epoch, epoch_iter, losses,
                                                t, t_data)
                log["losses"].append(losses)
                log["step_seconds"].append(time.time() - iter_start_time)

            if total_steps % cfg.save_latest_freq == 0:
                logging.info("saving the latest model (epoch %d, "
                             "total_steps %d)", epoch, total_steps)
                model.save_networks("latest")
            iter_data_time = time.time()

        if epoch % cfg.save_epoch_freq == 0:
            logging.info("saving the model at the end of epoch %d, iters %d",
                         epoch, total_steps)
            model.save_networks("latest")
            model.save_networks(epoch)

        print(f"End of epoch {epoch} / {cfg.niter + cfg.niter_decay} \t "
              f"Time Taken: {int(time.time() - epoch_start_time)} sec")
        model.update_learning_rate()
    return log
