"""Region-of-interest (face) masking — the reference's dlib subsystem
(reference ``src/dlibFaceSelect.cpp``) rebuilt as device code.

The reference gates every pixel loop on a face mask built two ways:
``getFaceMask`` (convex polygon over dlib jaw+brow landmarks, ``:29-36``)
and ``getFaceCircle`` (ellipse from landmarks 0/16/8 with empirical scale
factors, ``:50-62``). dlib's HOG detector is host C++ and reloads its 100 MB
model every call (``:21``); here the geometric mask constructions are pure
jitted JAX taking landmarks from ANY detector, plus a landmark-free
moment-based ellipse detector so the pipeline is self-contained on device.
"""

from stereovisionarray_tpu.roi.mask import (  # noqa: F401
    convex_polygon_mask,
    ellipse_mask,
    face_ellipse_from_landmarks,
    face_mask_from_landmarks,
)
from stereovisionarray_tpu.roi.detect import detect_face_ellipse  # noqa: F401
from stereovisionarray_tpu.roi.face import (  # noqa: F401
    FaceDetection,
    canonical_landmarks,
    detect_face,
    face_mask,
)
