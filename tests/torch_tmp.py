"""Free each port test module's temporary directories when the module ends.

pytest keeps every ``tmp_path`` and ``tmp_path_factory.mktemp`` directory of a
session until a later session prunes it, and keeps the last three sessions.
The port's tests write checkpoints of whole networks (a fine-tune run's
three nets and Adam state come to about 350 MB a save), so a whole run left
about 8 GB behind and a full disk cut the run short. A module that imports
this fixture removes, at its end, the directories it made under the
session's (or the xdist worker's) base directory: each worker runs one
module at a time, so the peak is one module's files, not the suite's.
"""

import os
import shutil

import pytest


@pytest.fixture(scope="module", autouse=True)
def free_temp_dirs(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    before = set(os.listdir(base))
    yield
    for name in set(os.listdir(base)) - before:
        shutil.rmtree(base / name, ignore_errors=True)
