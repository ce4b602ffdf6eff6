from .tipsy import (  # noqa: F401
    TipsyHeader,
    ParticleSet,
    read_tipsy,
    write_tipsy_star,
    header_dtype,
    GAS_DTYPE,
    DARK_DTYPE,
    STAR_DTYPE,
)
from .catalogs import (  # noqa: F401
    GroupCatalog,
    read_gtp_list,
    read_stat,
    read_mark,
)
