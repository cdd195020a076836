"""CLI entry of the port: ``python -m slowfast_tpu_torch.run_net --cfg ...
--opts ...`` (counterpart of tools/run_net.py).

Trains when ``TRAIN.ENABLE``, then runs the multi-view test when
``TEST.ENABLE``, on ``--device`` (``cuda`` unless asked otherwise).
"""

from slowfast_tpu_torch.config import assert_and_infer_cfg
from slowfast_tpu_torch.utils.parser import load_config, parse_args


def main(argv=None):
    args = parse_args(argv)
    for path_to_config in args.cfg_files or [None]:
        cfg = assert_and_infer_cfg(load_config(args, path_to_config))
        if cfg.TRAIN.ENABLE:
            from slowfast_tpu_torch.engine.trainer import train

            train(cfg, args.device)
        if cfg.TEST.ENABLE:
            from slowfast_tpu_torch.engine.tester import test

            if cfg.TEST.NUM_ENSEMBLE_VIEWS == -1:
                # Sweep the standard view counts (reference run_net.py:31-35).
                for num_view in [1, 3, 5, 7, 10]:
                    cfg.TEST.NUM_ENSEMBLE_VIEWS = num_view
                    test(cfg, args.device)
            else:
                test(cfg, args.device)


if __name__ == "__main__":
    main()
