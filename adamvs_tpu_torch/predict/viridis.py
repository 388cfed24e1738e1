"""The viridis colour map of the preview PNGs, without matplotlib.

``VIRIDIS_RGB`` is matplotlib's 256-entry viridis table (``cm.viridis``, a
``ListedColormap``) as the uint8 RGB that ``(cm.viridis(x)[..., :3] * 255)
.astype(np.uint8)`` gives for each entry, and ``viridis_rgb`` indexes it as
``Colormap.__call__`` does for float input, so that matplotlib is not a
dependency of the port.
"""

from __future__ import annotations

import numpy as np

VIRIDIS_RGB = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
    "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
    "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
    "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
    "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"
), dtype=np.uint8).reshape(256, 3)


def viridis_rgb(x: np.ndarray) -> np.ndarray:
    """uint8 RGB [..., 3] of float ``x`` as matplotlib maps it: index
    ``floor(256 x)``, 1.0 to the last entry, values below 0 to the first and
    above 1 to the last, NaN to black."""
    xa = np.array(x, dtype=np.float64) * 256.0
    bad = np.isnan(xa)
    idx = np.clip(np.where(bad, 0.0, xa), 0.0, 255.0).astype(np.intp)
    out = VIRIDIS_RGB[idx]
    out[bad] = 0
    return out
