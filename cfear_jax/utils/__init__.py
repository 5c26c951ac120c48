from cfear_jax.utils import se2  # noqa: F401
from cfear_jax.utils.stats import timing  # noqa: F401
