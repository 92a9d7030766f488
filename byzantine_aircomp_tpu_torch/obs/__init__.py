"""Host-side run services of the port: for now the writer thread
(:mod:`.writer`), which checkpoint writes and the record pickle ride."""

from .writer import WriterThread, resolve_async

__all__ = ["WriterThread", "resolve_async"]
