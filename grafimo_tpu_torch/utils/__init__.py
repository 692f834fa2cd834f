from grafimo_tpu_torch.utils.constants import (  # noqa: F401
    ALL_CHROMS,
    CHROMS_LIST,
    DEFAULT_OUTDIR,
    DNA_ALPHABET,
    LOG_FACTOR,
    NOMAP,
    PHASE,
    PSEUDOBG,
    RANGE,
    REV_COMPL,
    SOURCE,
    TP,
    UNIF,
)
from grafimo_tpu_torch.utils.misc import (  # noqa: F401
    almost_equal,
    is_numeric,
    lg2,
    parse_namemap,
)
from grafimo_tpu_torch.utils.sniff import (  # noqa: F401
    is_bed,
    is_jaspar,
    is_meme,
    is_pfm,
    is_transfac,
    sniff_motif_format,
)
