"""Convert an ARPA language model to KenLM's PROBING binary format.

Usage: python -m speecht_tpu_torch.tools.arpa_to_kenlm_binary model.arpa kenlm-model.binary

The port of ``tools/arpa_to_kenlm_binary.py``, through the port's own
writer (``native.lm_write_binary``, ``native/kenlm_binary.cpp``): the same
bytes for the same ARPA. The output loads through the reader the beam
decoders use (the host beam's ``native.NGramLM`` and the device beam's
``DeviceLM.from_binary``), and through KenLM itself: the format follows
lm/binary_format.cc (magic/sanity header, fixed-width parameters, probing
vocabulary + n-gram hash tables, embedded word strings).
``python -m speecht_tpu_torch evaluate --language-model <dir>`` picks up a
``*.binary`` in the directory. The conversion runs on the host alone.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 2:
        print(__doc__)
        return 1
    from speecht_tpu_torch import native

    native.lm_write_binary(argv[0], argv[1])
    print(f"wrote {argv[1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
