"""Wrapping the names that the program's layers call, from the
benchmark's side: no file of the program is edited.

A target is ``"package.module:attr"`` or ``"package.module:Class.attr"``
(a method, wrapped on the class that defines it).  ``patched`` puts a
wrapper in its place for the length of a block and restores it after.
A target that no longer exists (a later change renamed it) is reported
by ``exists`` and left alone, and whatever reads it reads nothing.
"""
from __future__ import annotations

import contextlib
import importlib
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch


def _resolve(target: str) -> Tuple[object, str]:
    """(owner, attribute name) of a target."""
    module_name, _, path = target.partition(":")
    owner = importlib.import_module(module_name)
    parts = path.split(".")
    for part in parts[:-1]:
        owner = getattr(owner, part)
    return owner, parts[-1]


def exists(target: str) -> bool:
    try:
        owner, attr = _resolve(target)
    except (ImportError, AttributeError):
        return False
    return hasattr(owner, attr)


@contextlib.contextmanager
def patched(wrappers: Dict[str, Callable[[Callable], Callable]]
            ) -> Iterator[None]:
    """Inside the block each existing target is ``make(original)``; the
    originals come back on exit, in reverse order."""
    done: List[Tuple[object, str, object]] = []
    try:
        for target, make in wrappers.items():
            if not exists(target):
                continue
            owner, attr = _resolve(target)
            original = (owner.__dict__[attr] if isinstance(owner, type)
                        else getattr(owner, attr))
            setattr(owner, attr, make(original))
            done.append((owner, attr, original))
        yield
    finally:
        for owner, attr, original in reversed(done):
            setattr(owner, attr, original)


class Spans:
    """Host-clock spans of wrapped calls, each opened and closed on a
    device synchronise, so that a span holds the device work its call
    queued: ``events[label]`` is a list of (start, end) seconds."""

    def __init__(self, device: torch.device):
        self.device = device
        self.events: Dict[str, List[Tuple[float, float]]] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrapper(self, label: str) -> Callable[[Callable], Callable]:
        def make(fn):
            def span(*args, **kwargs):
                self._sync()
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self._sync()
                    self.events.setdefault(label, []).append(
                        (t0, time.perf_counter()))
            return span
        return make


def labelled(label: str, on_enter: Optional[Callable[[], None]] = None
             ) -> Callable[[Callable], Callable]:
    """A wrapper that names the call in a profiler trace (no sync), and
    calls ``on_enter`` first."""
    def make(fn):
        def call(*args, **kwargs):
            if on_enter is not None:
                on_enter()
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return call
    return make


def recorded(calls: List[Tuple[tuple, dict]], when: Callable[[], bool]
             ) -> Callable[[Callable], Callable]:
    """A wrapper that keeps the arguments (no sync, no copy) of each call
    made while ``when()`` holds."""
    def make(fn):
        def call(*args, **kwargs):
            if when():
                calls.append((args, kwargs))
            return fn(*args, **kwargs)
        return call
    return make
