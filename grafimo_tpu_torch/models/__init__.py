from grafimo_tpu_torch.models.motif import Motif, MotifSet  # noqa: F401
from grafimo_tpu_torch.models.parse import load_motifs  # noqa: F401
