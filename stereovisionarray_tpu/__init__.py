"""stereovisionarray_tpu — a multi-view stereo / SfM engine in JAX.

A brand-new JAX / XLA / Pallas framework with the capabilities of the
reference C++ project Nahuel-M/StereoVisionArray (5x5 camera-array stereo:
epipolar block matching, disparity->depth, multi-view warp refinement,
face-ROI gating, golden-reference evaluation), redesigned as whole-array
device programs:

 - batched pinhole camera geometry (``geometry/``) replaces the scalar
   translation-only ``Camera`` class (reference ``src/Camera.cpp:15-33``);
 - census / Birchfield-Tomasi cost volumes + 8-path semi-global matching as
   vectorized XLA scans and a Triton kernel on NVIDIA GPUs (``ops/``) replace the
   per-pixel Bresenham SAD loop (reference ``src/CameraStereoVision.cpp:49-95``);
 - N-view plane-sweep fusion (``models/plane_sweep.py``) generalizes the
   pairwise warp refinement (reference ``src/functions.cpp:11-103``);
 - feature matching + bundle adjustment (``models/sfm.py``) replaces
   hard-coded camera poses (reference ``src/CameraStereoVision.cpp:33-39``);
 - mesh sharding of the disparity axis / tiles / frames (``parallel/``)
   provides the scale-out path the single-threaded reference lacks.
"""

__version__ = "0.1.0"

from stereovisionarray_tpu import config as config  # noqa: F401
