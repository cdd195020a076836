"""Normalise reference-format recipe YAMLs against the port's config schema
(counterpart of tools/import_config.py).

The schema is key-compatible with the reference (config/defaults.py), so an
upstream recipe merges directly. ``normalize`` validates a recipe with
``merge_from_file`` and ``assert_and_infer_cfg`` and re-emits only the keys
it sets, the sections sorted and the keys within each sorted, under a
provenance header.

    python -m slowfast_tpu_torch.import_config SRC.yaml [SRC2.yaml ...] --out-dir configs/X
"""

import argparse
import os

import yaml

from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg


def normalize(src_path, header_note=""):
    """``(yaml_text, cfg)`` of a reference-format recipe."""
    cfg = get_cfg()
    cfg.merge_from_file(src_path)
    cfg = assert_and_infer_cfg(cfg)
    with open(src_path) as f:
        raw = yaml.safe_load(f)
    sections = {sec: ({k: raw[sec][k] for k in sorted(raw[sec])}
                      if isinstance(raw[sec], dict) else raw[sec])
                for sec in sorted(raw)}
    lines = [f"# Recipe: {os.path.splitext(os.path.basename(src_path))[0]}",
             "# Reproduces the reference training recipe of the same name",
             "# (values validated against slowfast_tpu_torch/config/defaults.py)."]
    if header_note:
        lines.append(f"# {header_note}")
    body = yaml.safe_dump(sections, sort_keys=False, default_flow_style=None, width=78)
    return "\n".join(lines) + "\n" + body, cfg


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="+")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--note", default="")
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for src in args.sources:
        try:
            text, _ = normalize(src, args.note)
        except Exception as e:  # noqa: BLE001 -- one bad recipe does not stop the rest
            print(f"SKIP {src}: {e}")
            continue
        dst = os.path.join(args.out_dir, os.path.basename(src))
        with open(dst, "w") as f:
            f.write(text)
        print(f"wrote {dst}")


if __name__ == "__main__":
    main()
