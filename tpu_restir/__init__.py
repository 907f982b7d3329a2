"""tpu-restir: a ReSTIR direct-illumination progressive path tracer in JAX.

JAX/XLA/Pallas implementation, run on NVIDIA GPUs, with the capabilities of the
reference CPU renderer Tonz24/restir-embree (see SURVEY.md for the
structural analysis this build follows). All render state is explicit
pytrees of arrays; every pass is a pure function; parallelism is
expressed with jax.sharding meshes instead of OpenMP threads.
"""

__version__ = "0.1.0"

from tpu_restir.config import (  # noqa: F401
    CameraConfig,
    RenderConfig,
    RenderParams,
    RestirParams,
)
