"""tikejax — ptychography reconstruction in JAX/XLA.

Brand-new framework with the capabilities of nikitinvv/libtike-cufft
(see SURVEY.md): far-field fwd/adj diffraction operators, joint
object+probe Dai-Yuan conjugate-gradient solver with Gaussian and Poisson
likelihoods, backtracking line search, multi-mode probes, position
minibatching, and scan-axis sharding across a device mesh.
"""

from tikejax.geometry import Geometry
from tikejax.ops.diffraction import Ptycho
from tikejax.solvers import CGOptions, run

__version__ = "0.1.0"

__all__ = ["Geometry", "Ptycho", "CGOptions", "run", "__version__"]
