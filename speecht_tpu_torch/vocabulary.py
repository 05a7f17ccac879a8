"""Character vocabulary for CTC speech recognition.

Counterpart of ``speecht_tpu/vocabulary.py``: 28 symbols (a-z -> 0-25,
apostrophe -> 26, space -> 27) plus the CTC blank as class 28, so logits
have 29 classes. Dense label arrays are padded with ``PAD_ID``.
"""

from __future__ import annotations

APOSTROPHE_ID = 26
SPACE_ID = 27
SIZE = 28  # number of real (non-blank) classes
BLANK_ID = SIZE  # CTC blank = 28
NUM_CLASSES = SIZE + 1

PAD_ID = -1  # padding value in dense label arrays (never a valid class)

_CHAR_BY_ID = [chr(ord("a") + i) for i in range(26)] + ["'", " "]
_ID_BY_CHAR = {c: i for i, c in enumerate(_CHAR_BY_ID)}


def sentence_to_ids(sentence: str) -> list[int]:
    """Encode a sentence (lowercased first) to a list of ids."""
    return [_ID_BY_CHAR[c] for c in sentence.lower()]


def ids_to_sentence(identifiers) -> str:
    """Decode a sequence of ids to a string. Ignores PAD_ID and BLANK_ID."""
    return "".join(
        _CHAR_BY_ID[int(i)] for i in identifiers if 0 <= int(i) < SIZE
    )
