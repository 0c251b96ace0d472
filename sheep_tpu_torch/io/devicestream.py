"""Streams that synthesize their chunks on the device: the ``DeviceStream``
protocol (the port's copy of ``sheep_tpu/io/devicestream.py``).

A device stream materializes each padded ``(C, 2)`` int32 chunk in the
device's memory, so a build over one stages no host bytes per chunk: no
host generation, no host-to-device copy, no staging ring. The backend's
chunk supplier recognizes the protocol through :func:`is_device_stream`
and counts each synthesized chunk with :func:`note_device_chunks`.

Contract:

- ``device_chunk(idx, chunk_edges, n, device)`` returns the
  ``(chunk_edges, 2)`` int32 tensor on ``device`` for global chunk
  ``idx``, rows past the real edge count holding the sentinel vertex
  ``n``, bit-equal to the padded host chunk of the same stream;
- ``num_chunks(chunk_edges)`` returns the total chunk count;
- chunk access is random: any index on its own, so a resume from a later
  chunk and the chunk cache's prefix read exactly what a full pass reads.

The reference's ``device_chunk_on`` (a placement hook for its multi-device
drivers) has no counterpart: ``device_chunk`` takes the device itself.
Host-format streams (files, arrays, replay generators) are not device
streams; they take the staged ring (``utils/prefetch.H2DRing``).
"""

from __future__ import annotations


class DeviceStream:
    """Marker class for streams whose padded chunks materialize directly
    in device memory (contract above). Subclasses implement
    :meth:`device_chunk`; the stream surface (``chunks``,
    ``num_vertices``, ...) comes from the concrete class."""

    def device_chunk(self, idx: int, chunk_edges: int, n: int, device):
        """The padded ``(chunk_edges, 2)`` int32 chunk ``idx`` on
        ``device`` (sentinel ``n`` past the real edge count)."""
        raise NotImplementedError


def is_device_stream(stream) -> bool:
    """True when ``stream`` synthesizes padded chunks on the device: a
    :class:`DeviceStream`, or any object with a callable
    ``device_chunk``."""
    return isinstance(stream, DeviceStream) or \
        callable(getattr(stream, "device_chunk", None))


def note_device_chunks(stats, count: int = 1) -> None:
    """Count ``count`` device-synthesized chunks into a driver's ``stats``:
    adds to ``device_stream_chunks`` and sets ``h2d_staged_bytes`` to 0
    where no pass has staged bytes yet, the record that the path staged
    no host bytes per chunk."""
    if stats is None:
        return
    stats.setdefault("h2d_staged_bytes", 0)
    stats["device_stream_chunks"] = \
        stats.get("device_stream_chunks", 0) + count
