from .stream import (ParagraphStreamingPredictor, StreamingPredictor,  # noqa: F401
                     ensemble_serve_fn)
from .server import BatchingServer  # noqa: F401
from .http_api import HttpFrontend  # noqa: F401
from .export import export_predictor, load_predictor  # noqa: F401
