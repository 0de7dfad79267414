from .stream import (ParagraphStreamingPredictor, StreamingPredictor,  # noqa: F401
                     ensemble_serve_fn)
from .server import BatchingServer  # noqa: F401
