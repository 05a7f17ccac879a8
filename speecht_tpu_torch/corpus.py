"""LibriSpeech corpus acquisition.

Counterpart of ``speecht_tpu/corpus.py``: downloads the LibriSpeech
tarballs from openslr.org/resources/12 and extracts the members under the
``LibriSpeech/`` tar root, with that prefix stripped, into
``data/{train,dev,test}``. It is idempotent: a set whose extraction
directory exists is neither downloaded nor extracted again, so a corpus
laid out by hand (or by a test) with those directories present is used
as it is.

The sets are the reference's: dev-clean, train-clean-100,
train-clean-360, train-other-500, test-clean.
"""

from __future__ import annotations

import os
import tarfile
import urllib.request

TRAIN_DIR = "train"
DEV_DIR = "dev"
TEST_DIR = "test"

DEV_CLEAN_SET = "dev-clean"
TRAIN_CLEAN_100_SET = "train-clean-100"
TRAIN_CLEAN_360_SET = "train-clean-360"
TRAIN_OTHER_500_SET = "train-other-500"
TEST_CLEAN_SET = "test-clean"

DATA_SETS = frozenset(
    {
        (DEV_DIR, DEV_CLEAN_SET),
        (TRAIN_DIR, TRAIN_CLEAN_100_SET),
        (TRAIN_DIR, TRAIN_CLEAN_360_SET),
        (TRAIN_DIR, TRAIN_OTHER_500_SET),
        (TEST_DIR, TEST_CLEAN_SET),
    }
)

BASE_URL = "http://www.openslr.org/resources/12/"
SET_FILE_EXTENSION = ".tar.gz"
TAR_ROOT = "LibriSpeech/"


class SpeechCorpusProvider:
    """Ensures the LibriSpeech corpus is under ``data_directory``."""

    def __init__(self, data_directory: str):
        self._data_directory = data_directory
        os.makedirs(data_directory, exist_ok=True)
        os.makedirs(os.path.join(data_directory, DEV_DIR), exist_ok=True)
        os.makedirs(os.path.join(data_directory, TRAIN_DIR), exist_ok=True)

    def _download_if_not_exists(self, remote_file_name: str) -> str:
        path = os.path.join(self._data_directory, remote_file_name)
        if not os.path.exists(path):
            print(f"Downloading {remote_file_name}...")
            urllib.request.urlretrieve(BASE_URL + remote_file_name, path)
        return path

    def _extract_from_to(
        self, tar_file_name: str, source: str, target_directory: str
    ) -> None:
        print(f"Extracting {tar_file_name}...")
        with tarfile.open(tar_file_name, "r:gz") as tar:
            members = []
            for info in tar.getmembers():
                if info.name.startswith(TAR_ROOT + source):
                    info.name = info.name.replace(TAR_ROOT, "", 1)
                    members.append(info)
            tar.extractall(target_directory, members, filter="data")

    def _is_ready(self, data_sets=DATA_SETS) -> bool:
        return all(
            os.path.exists(
                os.path.join(self._data_directory, set_type, set_name)
            )
            for set_type, set_name in data_sets
        )

    def _download(self, data_sets=DATA_SETS) -> None:
        for _set_type, set_name in data_sets:
            self._download_if_not_exists(set_name + SET_FILE_EXTENSION)

    def _extract(self, data_sets=DATA_SETS) -> None:
        for set_type, set_name in data_sets:
            local_file = os.path.join(
                self._data_directory, set_name + SET_FILE_EXTENSION
            )
            target_directory = os.path.join(self._data_directory, set_type)
            self._extract_from_to(local_file, set_name, target_directory)

    def ensure_availability(self, test_only: bool = False) -> None:
        data_sets = [(TEST_DIR, TEST_CLEAN_SET)] if test_only else DATA_SETS
        if not self._is_ready(data_sets):
            self._download(data_sets)
            self._extract(data_sets)
