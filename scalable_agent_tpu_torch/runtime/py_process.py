"""Process-hosted Python objects, ported from the JAX package's
runtime/py_process.py (the reference's py_process without the TF graph).

Runs a Python class (an environment) in its own OS process — the GIL
escape that lets dozens of envs step at once — and exposes its methods as
blocking calls over a pipe:

- `PyProcess(type_, constructor_kwargs)` and `.proxy.<method>(*args)`:
  the call goes over a `multiprocessing.Pipe` and the caller blocks on
  the reply.
- Classes declare the dtypes and shapes of their replies with
  `_tensor_specs(method_name, kwargs, constructor_kwargs)`; the parent
  checks each reply against them (`SpecMismatchError`).
- A class may declare `_process_setup()`, which the child runs before
  the constructor: process-wide settings for a process that hosts only
  this object (the on-device cores' host envs run torch on one thread).
- An exception raised in the constructor or a method is sent back with
  its traceback and raised at the call site (`RemoteError`); the worker
  keeps serving after a method error.
- A closed or broken pipe raises `ProcessClosed`.

Start method: `forkserver` by default. A child forked from a process that
has initialised CUDA cannot use it, and a plain fork from a parent that
runs threads copies whatever locks they hold. The forkserver is a fresh
interpreter, and every child is forked from it; `warm_forkserver()`
starts it, and the entry points call it before their first CUDA call.
Each child re-runs the parent's main module (multiprocessing's rule), so
the entry points have the forkserver import that module's imports once
(`preload`): a child then starts in milliseconds instead of importing
torch anew.
Constructor kwargs and the hosted class must be picklable (module level).
This module imports numpy and the standard library only, so a child
imports no torch to host an env.
"""

import multiprocessing
import pickle
import threading
import traceback

import numpy as np

DEFAULT_START_METHOD = 'forkserver'


def warm_forkserver(preload=()):
  """Start the forkserver process now (idempotent), importing the modules
  named in `preload` into it first (a no-op once it runs)."""
  from multiprocessing import forkserver
  if preload:
    multiprocessing.set_forkserver_preload(list(preload))
  forkserver.ensure_running()


def stop_forkserver():
  """Stop the forkserver and its resource tracker, so a program that
  started them leaves no process behind (a no-op when none runs)."""
  from multiprocessing import forkserver, resource_tracker
  forkserver._forkserver._stop()
  tracker = resource_tracker._resource_tracker
  if getattr(tracker, '_pid', None) is not None:  # a process may have none
    tracker._stop()


class ProcessClosed(Exception):
  """The hosted process's pipe is closed (clean shutdown or death)."""


class RemoteError(Exception):
  """An exception raised inside the hosted process; carries the remote
  traceback, with the original exception (when picklable) as
  `__cause__`."""


class SpecMismatchError(Exception):
  """A method reply did not match the class's `_tensor_specs`."""


_CLOSE = '__process_close__'


def _worker(conn, type_, constructor_kwargs):
  """Worker loop: set up, construct, then serve (method, args, kwargs)
  requests."""
  try:
    setup = getattr(type_, '_process_setup', None)
    if setup is not None:
      setup()
    obj = type_(**constructor_kwargs)
  except Exception as e:  # reported on the first proxy call
    conn.send(('exception', _serialize_error(e)))
    conn.close()
    return
  while True:
    try:
      request = conn.recv()
    except (EOFError, OSError):
      break  # the parent died or closed: close the object
    method, args, kwargs = request
    if method == _CLOSE:
      try:
        if hasattr(obj, 'close'):
          obj.close()
        conn.send(('ok', None))
      except Exception as e:
        conn.send(('exception', _serialize_error(e)))
      break
    try:
      conn.send(('ok', getattr(obj, method)(*args, **kwargs)))
    except Exception as e:  # keep serving
      conn.send(('exception', _serialize_error(e)))
  try:
    conn.close()
  except OSError:
    pass


def _serialize_error(e):
  tb = ''.join(traceback.format_exception(type(e), e, e.__traceback__))
  try:
    pickle.dumps(e)
    payload = e
  except Exception:
    payload = None  # unpicklable exception: text only
  return (payload, tb)


def _validate_specs(result, specs, method):
  """Check a reply against an ArraySpec nest (None = no check)."""
  if specs is None:
    return
  if hasattr(specs, 'shape') and hasattr(specs, 'dtype'):
    arr = np.asarray(result)
    if tuple(arr.shape) != tuple(specs.shape) or arr.dtype != specs.dtype:
      raise SpecMismatchError(
          f'{method}: got shape={arr.shape} dtype={arr.dtype}, '
          f'spec requires shape={tuple(specs.shape)} dtype={specs.dtype}')
    return
  if isinstance(specs, (tuple, list)):
    if not isinstance(result, (tuple, list)) or len(result) != len(specs):
      raise SpecMismatchError(
          f'{method}: reply structure {type(result).__name__}'
          f'/{len(result) if hasattr(result, "__len__") else "?"} does '
          f'not match spec structure of length {len(specs)}')
    for r, s in zip(result, specs):
      _validate_specs(r, s, method)
    return
  raise SpecMismatchError(f'{method}: unsupported spec node {specs!r}')


class _Proxy:
  """Attribute access builds blocking remote calls."""

  def __init__(self, process):
    self._process = process

  def __getattr__(self, name):
    if name.startswith('_'):
      raise AttributeError(name)

    def call(*args, **kwargs):
      return self._process._call(name, args, kwargs)

    call.__name__ = name
    return call


class PyProcess:
  """Hosts an instance of `type_` in a child OS process.

  Args:
    type_: class to instantiate in the child; replies are checked
      against its `_tensor_specs` when it has one.
    constructor_kwargs: kwargs of the child-side constructor (picklable).
    context: multiprocessing start method (None: 'forkserver').
    validate_specs: False skips the reply checks.
  """

  def __init__(self, type_, constructor_kwargs=None, context=None,
               validate_specs=True):
    self._type = type_
    self._constructor_kwargs = dict(constructor_kwargs or {})
    self._ctx = multiprocessing.get_context(
        context or DEFAULT_START_METHOD)
    self._validate = validate_specs and hasattr(type_, '_tensor_specs')
    self._conn = None
    self._process = None
    self._lock = threading.Lock()  # pipes are not thread-safe
    self._closed = False

  @property
  def proxy(self):
    return _Proxy(self)

  def start(self):
    if self._process is not None:
      raise RuntimeError('already started')
    self._conn, child_conn = self._ctx.Pipe(duplex=True)
    self._process = self._ctx.Process(
        target=_worker,
        args=(child_conn, self._type, self._constructor_kwargs),
        daemon=True)
    self._process.start()
    child_conn.close()  # the parent keeps one end only
    return self

  def _call(self, method, args, kwargs):
    with self._lock:
      if self._closed or self._conn is None:
        raise ProcessClosed(f'{self._type.__name__} process not running')

      def handle_closed_pipe(e):
        # A child whose constructor failed sends its error and closes
        # its end: drain that reply so the error is not lost.
        buffered = self._drain_buffered_reply()
        if buffered is None:
          raise ProcessClosed(
              f'{self._type.__name__} process pipe closed') from e
        return buffered

      reply = None
      try:
        self._conn.send((method, args, kwargs))
      except (EOFError, OSError, BrokenPipeError) as e:
        reply = handle_closed_pipe(e)
      except Exception as e:
        raise TypeError(
            f'could not serialize request for '
            f'{self._type.__name__}.{method}: {e!r}') from e
      if reply is None:
        try:
          reply = self._conn.recv()
        except (EOFError, OSError, BrokenPipeError) as e:
          reply = handle_closed_pipe(e)
        except Exception as e:
          raise RemoteError(
              f'in hosted {self._type.__name__}.{method}: reply could '
              f'not be deserialized ({e!r})') from e
      status, payload = reply
    if status == 'exception':
      exc, tb = payload
      err = RemoteError(
          f'in hosted {self._type.__name__}.{method}:\n{tb}')
      if exc is not None:
        raise err from exc
      raise err
    if self._validate:
      specs = self._type._tensor_specs(method, kwargs,
                                       self._constructor_kwargs)
      _validate_specs(payload, specs, f'{self._type.__name__}.{method}')
    return payload

  def _drain_buffered_reply(self):
    """A reply the child sent before its pipe closed, if any."""
    try:
      if self._conn is not None and self._conn.poll(0):
        return self._conn.recv()
    except (EOFError, OSError, BrokenPipeError):
      pass
    return None

  def close(self, timeout=5.0):
    """Ask the child to close its object and exit; reap the process.
    Idempotent. When a call is blocked on a hung child (it holds the
    call lock), the child is terminated instead."""
    if not self._lock.acquire(timeout=timeout):
      self._closed = True
      if self._process is not None:
        self._process.terminate()
        self._process.join(timeout)
      return
    try:
      if self._closed:
        return
      self._closed = True
      conn, process = self._conn, self._process
      self._conn = None
    finally:
      self._lock.release()
    if conn is not None:
      try:
        conn.send((_CLOSE, (), {}))
        if conn.poll(timeout):
          conn.recv()
      except (EOFError, OSError, BrokenPipeError):
        pass
      try:
        conn.close()
      except OSError:
        pass
    if process is not None:
      process.join(timeout)
      if process.is_alive():
        process.terminate()
        process.join(timeout)

  @property
  def running(self):
    return (self._process is not None and self._process.is_alive()
            and not self._closed)


class ProxyEnv:
  """A hosted env's proxy with the `envs.base.Environment` surface, so an
  Actor drives an out-of-process env unchanged."""

  def __init__(self, process: PyProcess):
    self._process = process
    self._proxy = process.proxy

  def initial(self):
    return self._proxy.initial()

  def step(self, action):
    return self._proxy.step(action)

  def close(self):
    self._process.close()
