"""Image retrieval by mask similarity and deep features (port of
``cvcs_tpu/retrieval``): the reference's ``retrieval.ipynb`` as a
library."""

from cvcs_tpu_torch.retrieval.features import (  # noqa: F401
    extract_embedding,
    extract_features,
    rank_by_distance,
)
from cvcs_tpu_torch.retrieval.scores import (  # noqa: F401
    class_hist,
    compute_scores,
    get_best_match_idx,
    per_image_emd,
    per_image_miou,
    per_image_wiou,
    pixel_precision,
    rank_candidates,
    scores_evaluation,
)
