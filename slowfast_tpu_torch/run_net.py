"""CLI entry of the port: ``python -m slowfast_tpu_torch.run_net --cfg ...
--opts ...`` (counterpart of tools/run_net.py).

Trains when ``TRAIN.ENABLE``, then runs the multi-view test when
``TEST.ENABLE``, on ``--device`` (``cuda`` unless asked otherwise). A job
of more than one rank (``NUM_GPUS`` a host times ``--num_shards`` hosts)
spawns ``NUM_GPUS`` ranks on this host for each (``utils/multiprocessing``):
NCCL on the cards, gloo with ``--device cpu``. After the test, the
visualize tool runs when ``TENSORBOARD.ENABLE`` and ``MODEL_VIS`` or
``WRONG_PRED_VIS`` are set, then the demo under ``DEMO.ENABLE``, each in
this process on ``--device`` (tools/run_net.py:46-56).
"""

from slowfast_tpu_torch.config import assert_and_infer_cfg
from slowfast_tpu_torch.utils.multiprocessing import launch_job
from slowfast_tpu_torch.utils.parser import load_config, parse_args


def main(argv=None):
    args = parse_args(argv)
    for path_to_config in args.cfg_files or [None]:
        cfg = assert_and_infer_cfg(load_config(args, path_to_config))
        if cfg.TRAIN.ENABLE:
            from slowfast_tpu_torch.engine.trainer import train

            launch_job(cfg, args.device, train)
        if cfg.TEST.ENABLE:
            from slowfast_tpu_torch.engine.tester import test

            if cfg.TEST.NUM_ENSEMBLE_VIEWS == -1:
                # Sweep the standard view counts (reference run_net.py:31-35).
                for num_view in [1, 3, 5, 7, 10]:
                    cfg.TEST.NUM_ENSEMBLE_VIEWS = num_view
                    launch_job(cfg, args.device, test)
            else:
                launch_job(cfg, args.device, test)
        tb = cfg.TENSORBOARD
        if tb.ENABLE and (tb.MODEL_VIS.ENABLE or tb.WRONG_PRED_VIS.ENABLE):
            from slowfast_tpu_torch.visualization.vis import visualize

            visualize(cfg, args.device)
        if cfg.DEMO.ENABLE:
            from slowfast_tpu_torch.visualization.demo import demo

            demo(cfg, args.device)


if __name__ == "__main__":
    main()
