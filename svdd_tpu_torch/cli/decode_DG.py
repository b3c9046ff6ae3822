"""DG decode CLI (``svdd_tpu/cli/decode_DG.py``): the reference's
decode_DG.py is a DPS clone with the same flags and output name, kept
for script-name parity.

  python -m svdd_tpu_torch.cli.decode_DG --task dna --device cuda
"""

import logging

from svdd_tpu_torch.cli import decode_DPS


def parser():
  return decode_DPS.parser('DG (DPS-clone) decoding')


def main() -> None:
  logging.basicConfig(level=logging.INFO)
  decode_DPS.run(parser().parse_args())


if __name__ == '__main__':
  main()
