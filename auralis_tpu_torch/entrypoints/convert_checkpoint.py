"""CLI: convert an original Coqui XTTSv2 `.pth` checkpoint into the
dual-safetensors layout this framework (and the reference) loads.

Usage: python -m auralis_tpu_torch.entrypoints.convert_checkpoint ckpt.pth out_dir/
"""
import argparse

from ..models.xttsv2.weights import convert_coqui_checkpoint


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Coqui .pth -> auralis safetensors")
    parser.add_argument("checkpoint", help="path to the Coqui .pth checkpoint")
    parser.add_argument("output_dir", help="output directory")
    args = parser.parse_args(argv)
    gpt_dir, core_dir = convert_coqui_checkpoint(args.checkpoint, args.output_dir)
    print(f"GPT artifact:  {gpt_dir}")
    print(f"Core artifact: {core_dir}")


if __name__ == "__main__":
    main()
