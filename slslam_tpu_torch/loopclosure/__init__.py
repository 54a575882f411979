"""Loop closure of the port: vocabulary-tree place recognition and
landmark matching (port of slslam_tpu.loopclosure).  The tree descent, the
document scoring, the Bayesian filter and the descriptor matching run on
the tree's device; the inverted-file bookkeeping stays on the host."""

from .batch import BatchPlaceRecognizer  # noqa: F401
from .recognizer import PlaceRecognizer  # noqa: F401
from .voctree import VocTree, VocTreeParams, build_vocabulary  # noqa: F401
