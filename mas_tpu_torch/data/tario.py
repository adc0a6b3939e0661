"""Streaming reader of WebDataset-style tar shards, as
``mas_tpu/data/tario.py``.

  * a sample is the tar members that share a key (the name up to its
    first dot); each extension becomes a field of the sample's dict,
  * a shard is a local path or a ``pipe:<command>`` URL whose standard
    output is streamed (the subprocess is reaped when the shard ends or
    its reader is closed early),
  * ``shard_split`` deals shards over (process, data worker),
  * ``warn_and_continue`` is the per-sample error policy: warn and skip.

Host-side numpy and the standard library only; tar and JPEG work overlaps
the device's steps through ``prefetch.py``.
"""

from __future__ import annotations

import os
import subprocess
import tarfile
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Sequence


def warn_and_continue(exn: BaseException) -> bool:
    """Sample-level error policy: warn and skip."""
    warnings.warn(f"skipping sample after error: {exn!r}")
    return True


def _open_shard(url: str):
    """Local path or ``pipe:<cmd>`` -> (binary stream, subprocess or None).

    The subprocess is returned so that the reader reaps it once the
    stream is drained or closed; otherwise every pipe shard would leave a
    zombie for the life of the run."""
    if url.startswith("pipe:"):
        proc = subprocess.Popen(url[5:], shell=True, stdout=subprocess.PIPE,
                                bufsize=1 << 20)
        assert proc.stdout is not None
        return proc.stdout, proc
    return open(url, "rb"), None


def iter_tar_samples(
        url: str,
        handler: Callable[[BaseException], bool] = warn_and_continue
) -> Iterator[Dict[str, bytes]]:
    """Stream one tar shard -> dicts of {extension: bytes, '__key__': str,
    '__url__': str}.  Members that share a key (basename up to the first
    dot) form one sample; the tar's order groups them."""
    stream, proc = _open_shard(url)
    try:
        tf = tarfile.open(fileobj=stream, mode="r|*")
        current_key: Optional[str] = None
        sample: Dict[str, object] = {}
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            if "/" in name:
                name = name.rsplit("/", 1)[1]
            if "." not in name:
                key, ext = name, ""
            else:
                key, ext = name.split(".", 1)
            try:
                data = tf.extractfile(member).read()  # type: ignore
            except Exception as exn:                  # noqa: BLE001
                if handler(exn):
                    continue
                raise
            if key != current_key:
                if current_key is not None and sample:
                    yield sample  # type: ignore[misc]
                current_key = key
                sample = {"__key__": key, "__url__": url}
            sample[ext] = data
        if current_key is not None and sample:
            yield sample  # type: ignore[misc]
    except Exception as exn:                          # noqa: BLE001
        if not handler(exn):
            raise
    finally:
        stream.close()
        if proc is not None:
            # at EOF the command has exited: reap it; on an early close
            # its stdout is gone, but a command that ignores SIGPIPE
            # would block wait(), so terminate it first
            if proc.poll() is None:
                proc.terminate()
            proc.wait()


def shard_split(shards: Sequence[str], index: int, count: int,
                worker: int = 0, num_workers: int = 1) -> List[str]:
    """Interleaved shard assignment: every shard goes to exactly one
    (process ``index`` of ``count``, ``worker`` of ``num_workers``)."""
    total = max(count, 1) * max(num_workers, 1)
    slot = index * max(num_workers, 1) + worker
    return [s for i, s in enumerate(shards) if i % total == slot]


def expand_shards(root_or_urls) -> List[str]:
    """Directory -> its sorted ``.tar`` paths; a str or list passes."""
    if isinstance(root_or_urls, str):
        if os.path.isdir(root_or_urls):
            return sorted(
                os.path.join(root_or_urls, f)
                for f in os.listdir(root_or_urls) if f.endswith(".tar"))
        return [root_or_urls]
    return list(root_or_urls)
