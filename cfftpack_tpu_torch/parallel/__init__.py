"""Distribution layer over ``torch.distributed``: mesh helpers, batch
sharding, distributed FFTs.

Counterpart of ``cfftpack_tpu/parallel``, one process a rank: each
function takes and returns this rank's block of the JAX function's
global array (its ``PartitionSpec`` at the rank's mesh coordinate), and
the mesh is a ``DeviceMesh`` (:func:`make_mesh`).

* :mod:`batch` — batch sharding, no collective.
* :mod:`fourstep` — one long transform split N = N1*N2 across ranks with
  one all-to-all at the transpose.
* :mod:`fft2d` — 2-D FFT with a sharded axis and all-to-all transposes;
  :mod:`rowcol` — any separable 2-D transform the same way.

Every all-to-all is ``_comm.all_to_all_tiled``;
``_comm.count_collectives`` counts them.

Gradients.  Every function here is differentiable: the local passes
through the kernels' backward (``ops/_adjoint.py``), each all-to-all
through its adjoint, the all-to-all with the axes swapped
(``_comm._AllToAll``), so a forward and backward calls twice the
forward's ``all_to_all_single`` and no other collective.  As for
``torch.distributed.nn``'s functions:

* every rank of the group runs the backward through the same exchanges
  in the same order.  A rank whose loss does not use its block still
  calls ``backward`` on a loss that depends on it, for example
  ``(y * 0).sum()``; otherwise the other ranks wait in the backward's
  all-to-all;
* an output plane with no cotangent takes zeros (autograd's
  ``materialize_grads``);
* the gradient a rank receives is its block of the gradient of
  sum_r L_r(y_r), where L_r is rank r's loss on its block y_r.
"""
from .mesh import make_mesh, local_mesh, init_distributed  # noqa: F401
from .batch import shard_batch, pfft, pifft, prfft, pirfft, pdct  # noqa: F401
from .hp import pfft_hp, pifft_hp, prfft_hp  # noqa: F401
from .fourstep import fft_fourstep, ifft_fourstep  # noqa: F401
from .fourstep_split import (fft_fourstep_split,  # noqa: F401
                             ifft_fourstep_split)
from .fft2d import (fft2_sharded, ifft2_sharded,  # noqa: F401
                    fft2_sharded_split, ifft2_sharded_split,
                    rfft2_sharded, irfft2_sharded,
                    rfft2_sharded_split, irfft2_sharded_split)
from .rowcol import (rowcol2d_sharded, dctn2_sharded,  # noqa: F401
                     idctn2_sharded, dstn2_sharded, idstn2_sharded)

from ..utils.debug import api_exit as _api_exit  # noqa: E402

for _name, _fn in list(globals().items()):
    if (callable(_fn) and not _name.startswith("_")
            and _name not in ("make_mesh", "local_mesh", "init_distributed")):
        globals()[_name] = _api_exit(_fn)
