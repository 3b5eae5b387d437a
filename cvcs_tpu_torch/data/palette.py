"""GID15 label -> RGB palette, host side in numpy (port of
``cvcs_tpu/data/palette.py``)."""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 16  # 15 land-cover classes + background

LABELS = {
    0: "unlabeled", 1: "industrial land", 2: "urban residential",
    3: "rural residential", 4: "traffic land", 5: "paddy field",
    6: "irrigated cropland", 7: "dry cropland", 8: "garden plot",
    9: "arbor forest", 10: "shrub land", 11: "natural grassland",
    12: "artificial grassland", 13: "river", 14: "lake", 15: "pond",
}

# the confusion plot's axis labels
SHORT_LABELS = [
    "B", "IL", "UL", "RL", "TL", "PF", "IC", "DC",
    "GP", "AF", "SL", "NG", "AG", "R", "L", "P",
]

# label -> RGB
PALETTE = np.array(
    [
        (0, 0, 0),        # 0 unlabeled
        (200, 0, 0),      # 1 industrial land
        (250, 0, 150),    # 2 urban residential
        (200, 150, 150),  # 3 rural residential
        (250, 150, 150),  # 4 traffic land
        (0, 200, 0),      # 5 paddy field
        (150, 250, 0),    # 6 irrigated cropland
        (150, 200, 150),  # 7 dry cropland
        (200, 0, 200),    # 8 garden plot
        (150, 0, 250),    # 9 arbor forest
        (150, 150, 250),  # 10 shrub land
        (250, 200, 0),    # 11 natural grassland
        (200, 200, 0),    # 12 artificial grassland
        (0, 0, 200),      # 13 river
        (0, 150, 200),    # 14 lake
        (0, 200, 250),    # 15 pond
    ],
    dtype=np.uint8,
)


class GID15Palette:
    """Label mask -> color mask."""

    num_classes = NUM_CLASSES

    def decode_u8_host(self, mask) -> np.ndarray:
        """Label mask (...,) -> uint8 RGB (..., 3) through a 17-entry LUT;
        out-of-palette labels render white."""
        mask = np.asarray(mask)
        table = np.concatenate(
            [PALETTE, np.full((1, 3), 255, np.uint8)], axis=0)
        idx = np.where((mask >= 0) & (mask < NUM_CLASSES),
                       mask, NUM_CLASSES).astype(np.int64)
        return table[idx]

