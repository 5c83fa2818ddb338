"""Model-zoo path resolution: the port's own copy of
`xmask3d_tpu/utils/model_zoo.py`.

The reference's `sd://` and `odise://` checkpoint names resolve to files in
a local cache directory (`XMASK3D_MODEL_ZOO`, by default
~/.cache/xmask3d_tpu). Nothing is downloaded: a name whose file is not
there raises FileNotFoundError with the path it expects; plain paths pass
through.
"""

from __future__ import annotations

import os
from typing import Dict

_SD_FILES: Dict[str, str] = {
    "sd://v1-3": "sd-v1-3.ckpt",
    "sd://v1-4": "sd-v1-4.ckpt",
    "sd://v1-5": "sd-v1-5.ckpt",
}

_ODISE_FILES: Dict[str, str] = {
    "odise://b15n4": "b15n4.pth.tar",
    "odise://b12n7": "b12n7.pth.tar",
    "odise://b10n9": "b10n9.pth.tar",
    "odise://b170n30": "b170n30.pth.tar",
    "odise://b150n50": "b150n50.pth.tar",
}


def cache_dir() -> str:
    return os.environ.get(
        "XMASK3D_MODEL_ZOO",
        os.path.join(os.path.expanduser("~"), ".cache", "xmask3d_tpu"),
    )


def resolve(path: str) -> str:
    """The local file of an sd:// or odise:// name; a plain path as it is."""
    table = {**_SD_FILES, **_ODISE_FILES}
    if path in table:
        local = os.path.join(cache_dir(), table[path])
        if not os.path.exists(local):
            raise FileNotFoundError(
                f"{path} resolves to {local}; put the file there (nothing is downloaded)"
            )
        return local
    return path
