"""Build the port's CUDA kernels from the repo's sources and load them.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into a shared library, loaded with ctypes. Nothing here runs at import:
the first CUDA call of a kernel's wrapper builds it (`load`), and
`build_all` starts one nvcc per source, all at once, for callers that
want the build out of the way first.

The libraries go to `scalable_agent_tpu_torch/_build/` (listed in
.gitignore), named by a digest of the source and the flags, so an edited
source is rebuilt and concurrent builds never write the same file.
ptxas's report of each kernel's registers, shared memory and spills
(`-Xptxas -v`) is kept beside its library and read by `ptxas_report`.

Host C++ libraries (`ops/batcher/batcher.cc`, the dynamic batcher) are
built the same way by g++ (`load_host`): no CUDA, so they build on any
machine with a C++ compiler, and a failed build raises. Host test
executables (`ops/batcher/batcher_test.cc`, the batcher's native stress
test) are built by g++ plain and under ThreadSanitizer
(`build_host_tests`) and run by `run_host_test`.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, List, Optional

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(_PACKAGE_DIR, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


HOST_SOURCES = {'batcher': os.path.join(_PACKAGE_DIR, 'ops', 'batcher',
                                         'batcher.cc')}
GXX_FLAGS = ('-std=c++17', '-O2', '-fPIC', '-shared', '-pthread')

# Native test executables: the sources each links, and the g++ flags of
# each variant (those of the JAX package's batcher Makefile).
HOST_TESTS = {'batcher_test': (
    os.path.join(_PACKAGE_DIR, 'ops', 'batcher', 'batcher_test.cc'),
    HOST_SOURCES['batcher'])}
HOST_TEST_FLAGS = {
    'plain': ('-std=c++17', '-O2', '-Wall', '-Wextra', '-pthread'),
    'tsan': ('-std=c++17', '-O1', '-g', '-fsanitize=thread'),
}


class KernelBuildError(RuntimeError):
  """nvcc (or g++) is missing or refused a source."""


def nvcc_path() -> str:
  cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
  candidates = [shutil.which('nvcc')]
  for home in (cuda_home, '/usr/local/cuda'):
    if home:
      candidates.append(os.path.join(home, 'bin', 'nvcc'))
  for path in candidates:
    if path and os.path.isfile(path) and os.access(path, os.X_OK):
      return path
  raise KernelBuildError('nvcc not found (PATH, CUDA_HOME, /usr/local/'
                         'cuda/bin): the CUDA kernels need the CUDA '
                         'toolkit')


def sources() -> List[str]:
  """Kernel names: one per `csrc/*.cu`."""
  return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith('.cu'))


def _digest_path(name: str, source: str, flags) -> str:
  with open(source, 'rb') as f:
    digest = hashlib.sha256(f.read() + ' '.join(flags).encode())
  return os.path.join(BUILD_DIR, f'lib{name}-{digest.hexdigest()[:16]}.so')


def library_path(name: str) -> str:
  return _digest_path(name, os.path.join(CSRC_DIR, name + '.cu'),
                      NVCC_FLAGS)


def host_library_path(name: str) -> str:
  return _digest_path(name, HOST_SOURCES[name], GXX_FLAGS)


def _start(name: str, target: str, compiler_cmd):
  """Start `compiler_cmd + ['-o', tmp]` building `target`; None if it is
  already built."""
  if os.path.exists(target):
    return None
  os.makedirs(BUILD_DIR, exist_ok=True)
  fd, tmp = tempfile.mkstemp(prefix=f'lib{name}-', suffix='.so.tmp',
                             dir=BUILD_DIR)
  os.close(fd)
  cmd = [*compiler_cmd, '-o', tmp]
  try:
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
  except OSError as e:
    os.unlink(tmp)
    raise KernelBuildError(f'{" ".join(cmd)} could not start: {e}') from e
  return proc, tmp, target, cmd


def _start_build(name: str):
  """Start nvcc for `name` into a temp file; None if already built."""
  return _start(name, library_path(name),
                [nvcc_path(), *NVCC_FLAGS,
                 os.path.join(CSRC_DIR, name + '.cu')])


def _finish_build(build) -> None:
  if build is None:
    return
  proc, tmp, target, cmd = build
  output, _ = proc.communicate()
  if proc.returncode != 0:
    os.unlink(tmp)
    raise KernelBuildError(f'{" ".join(cmd)} failed '
                           f'({proc.returncode}):\n{output}')
  with open(_report_path(target), 'w') as f:
    f.write(output)
  os.replace(tmp, target)


def build_all(names: Optional[Iterable[str]] = None) -> List[str]:
  """Compile every named source (default: all of csrc/) in parallel, one
  nvcc each, and wait for all. Returns the library paths."""
  names = list(sources() if names is None else names)
  builds = [_start_build(n) for n in names]
  errors = []
  for build in builds:
    try:
      _finish_build(build)
    except KernelBuildError as e:
      errors.append(str(e))
  if errors:
    raise KernelBuildError('\n'.join(errors))
  return [library_path(n) for n in names]


def _report_path(library: str) -> str:
  return library[:-len('.so')] + '.ptxas.txt'


_FUNCTION = re.compile(r"Function properties for (\S+)")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:, used \d+ barriers)?"
                   r"(?:, (\d+) bytes smem)?")


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
  """Per kernel of the built `csrc/<name>.cu` (by mangled name):
  registers, static shared memory bytes and spill store/load bytes, as
  `-Xptxas -v` printed them when the library was built."""
  with open(_report_path(library_path(name))) as f:
    lines = f.read().splitlines()
  report: Dict[str, Dict[str, int]] = {}
  current = None
  for line in lines:
    match = _FUNCTION.search(line)
    if match:
      current = report.setdefault(match.group(1), {})
      continue
    if current is None:
      continue
    match = _SPILLS.search(line)
    if match:
      current['spill_stores'] = int(match.group(1))
      current['spill_loads'] = int(match.group(2))
    match = _USED.search(line)
    if match:
      current['registers'] = int(match.group(1))
      current['smem_bytes'] = int(match.group(2) or 0)
  return report


def _gxx() -> str:
  gxx = shutil.which('g++') or shutil.which('c++')
  if gxx is None:
    raise KernelBuildError('g++ not found on PATH: the host sources need '
                           'a C++ compiler')
  return gxx


def host_test_path(name: str, variant: str = 'plain') -> str:
  """Where the `variant` build of the test executable `name` goes, named
  by a digest of its sources and flags."""
  digest = hashlib.sha256(' '.join(HOST_TEST_FLAGS[variant]).encode())
  for source in HOST_TESTS[name]:
    with open(source, 'rb') as f:
      digest.update(f.read())
  return os.path.join(BUILD_DIR,
                      f'{name}-{variant}-{digest.hexdigest()[:16]}')


def build_host_tests(name: str, variants: Iterable[str] = ('plain',)
                     ) -> List[str]:
  """Build each variant of the test executable `name` with g++, one
  process per variant, all at once; returns their paths. A failed build
  raises KernelBuildError with g++'s output."""
  variants = list(variants)
  gxx = _gxx()
  os.makedirs(BUILD_DIR, exist_ok=True)
  builds = []
  for variant in variants:
    target = host_test_path(name, variant)
    if os.path.exists(target):
      continue
    fd, tmp = tempfile.mkstemp(prefix=f'{name}-{variant}-', suffix='.tmp',
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [gxx, *HOST_TEST_FLAGS[variant], *HOST_TESTS[name], '-o', tmp]
    builds.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True),
                   tmp, target, cmd))
  errors = []
  for proc, tmp, target, cmd in builds:
    output, _ = proc.communicate()
    if proc.returncode != 0:
      os.unlink(tmp)
      errors.append(f'{" ".join(cmd)} failed ({proc.returncode}):\n'
                    f'{output}')
    else:
      os.replace(tmp, target)
  if errors:
    raise KernelBuildError('\n'.join(errors))
  return [host_test_path(name, v) for v in variants]


def run_host_test(name: str, variant: str = 'plain',
                  timeout_secs: float = 120.0
                  ) -> subprocess.CompletedProcess:
  """Build (if needed) and run one variant of the test executable
  `name`; a TSAN build halts on its first report. Returns the finished
  process (the caller judges its exit code)."""
  exe, = build_host_tests(name, [variant])
  env = dict(os.environ)
  if variant == 'tsan':
    env['TSAN_OPTIONS'] = 'halt_on_error=1'
  return subprocess.run([exe], env=env, capture_output=True, text=True,
                        timeout=timeout_secs)


_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def load_host(name: str) -> ctypes.CDLL:
  """The loaded host library `name` (HOST_SOURCES), built by g++ into
  `_build/` first if needed; a failed build raises KernelBuildError."""
  with _load_lock:
    lib = _loaded.get('host:' + name)
    if lib is None:
      _finish_build(_start(name, host_library_path(name),
                           [_gxx(), *GXX_FLAGS, HOST_SOURCES[name]]))
      lib = ctypes.CDLL(host_library_path(name))
      _loaded['host:' + name] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
  """The loaded library of `csrc/<name>.cu`, built first if needed."""
  with _load_lock:
    lib = _loaded.get(name)
    if lib is None:
      build_all([name])
      lib = ctypes.CDLL(library_path(name))
      _loaded[name] = lib
    return lib
