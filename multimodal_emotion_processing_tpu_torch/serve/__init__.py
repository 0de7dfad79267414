from .stream import StreamingPredictor, ensemble_serve_fn  # noqa: F401
from .server import BatchingServer  # noqa: F401
