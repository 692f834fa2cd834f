"""Exception hierarchy (reference: ``src/grafimo/grafimo_errors.py:9-87``).

The reference wraps every failure in a subclass of its base error and routes
it through an ``exception_handler`` that prints a one-line message unless
``--debug`` is set.  We keep the same error taxonomy so CLI behaviour matches,
but raise normal exceptions internally; the CLI layer decides presentation.
"""

class GrafimoError(Exception):
    """Base class for all framework errors."""


class DependencyError(GrafimoError):
    pass


class FileReadError(GrafimoError):
    pass


class FileWriteError(GrafimoError):
    pass


class FileFormatError(GrafimoError):
    pass


class GraphError(GrafimoError):
    """Errors from the variation-graph engine (reference ``VGError``)."""


class MotifFileFormatError(GrafimoError):
    pass


class MotifFileReadError(GrafimoError):
    pass


class BGFileError(GrafimoError):
    pass


class MotifProcessingError(GrafimoError):
    pass


class NotValidMotifMatrixError(GrafimoError):
    pass


class SubprocessError(GrafimoError):
    pass
