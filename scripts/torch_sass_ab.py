"""Whether two checkouts of fast_tpu_torch compile a kernel to the same
machine code: builds one CUDA source in each (``ops/_build.build``, the
package's own flags, one process each) and compares the SASS of every
instantiation of some kernel functions (``cuobjdump -sass``, addresses
and encodings dropped), the ptxas lines beside.

    python scripts/torch_sass_ab.py OLD NEW [SOURCE [KERNEL,KERNEL...]]
        [--passes=3]

SOURCE defaults to ``synth_detect`` and the kernels to ``synth_pass1``.
With ``--passes=3`` an instantiation of NEW whose last template argument
is that TF32 pass count (``kPasses``, which OLD does not have) is matched
to OLD's instantiation of the other arguments, and NEW's other pass
counts are skipped: the 3xTF32 code of a checkout that added the pass
count against one without it. Runs on a machine with nvcc and cuobjdump
(the card's); prints one line per instantiation and a count.
"""

import os
import re
import subprocess
import sys


def build(root, source):
    """(library path, nvcc log) of ``source`` built in the checkout at
    ``root``, in a process of its own."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from fast_tpu_torch.ops import _build; "
            "i = _build.build(%r); print(i.path); print(i.log)")
    r = subprocess.run([sys.executable, "-c", code % (root, source)],
                       capture_output=True, text=True, check=True)
    path, _, log = r.stdout.partition("\n")
    return path, log


def template_args(name, kernel):
    """The template arguments of a mangled entry of ``kernel``, or None."""
    m = re.search(kernel + r"I((?:L[bi]\d+E)+)E", name)
    return m and tuple(re.findall(r"L[bi](\d+)E", m.group(1)))


def sass(path, kernel):
    """{template arguments: [instructions]} of ``kernel`` in a library."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    out = subprocess.run([tool if os.path.exists(tool) else "cuobjdump",
                          "-sass", path], capture_output=True, text=True,
                         check=True).stdout
    funcs = {}
    for f in re.split(r"\n\s*Function : ", out)[1:]:
        name, _, body = f.partition("\n")
        args = template_args(name, kernel)
        if args is None:
            continue
        funcs[args] = [re.sub(r"\s+", " ", re.sub(r"/\*[0-9a-f]+\*/", "",
                                                  ln)).strip()
                       for ln in body.splitlines() if "/*" in ln]
    return funcs


def ptxas(log, kernel):
    """{template arguments: ptxas's 'Used ...' line} of ``kernel``."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = template_args(m.group(1), kernel)
        elif cur and "Used" in line:
            out[cur] = line.split(":", 1)[-1].strip()
    return out


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    passes = next((a.split("=", 1)[1] for a in sys.argv[1:]
                   if a.startswith("--passes=")), None)
    old, new = (os.path.abspath(a) for a in args[:2])
    source = args[2] if len(args) > 2 else "synth_detect"
    kernels = (args[3] if len(args) > 3 else "synth_pass1").split(",")
    (po, lo), (pn, ln) = build(old, source), build(new, source)
    for kernel in kernels:
        so, sn = sass(po, kernel), sass(pn, kernel)
        ro, rn = ptxas(lo, kernel), ptxas(ln, kernel)
        same_n = total = 0
        for args_new, body in sorted(sn.items()):
            args_old = args_new
            if passes is not None:
                if args_new[-1] != passes:
                    continue
                args_old = args_new[:-1]
            total += 1
            if args_old not in so:
                print(f"{kernel}<{', '.join(args_new)}>: not in {old}")
                continue
            same = so[args_old] == body
            same_n += same
            print(f"{kernel}<{', '.join(args_new)}>: SASS "
                  f"{'identical' if same else 'different'} ({len(body)} and "
                  f"{len(so[args_old])} instructions); ptxas "
                  f"{rn.get(args_new)} and {ro.get(args_old)}")
        print(f"{source}.cu {kernel}: {same_n} of {total} instantiations "
              f"identical to {old}'s")


if __name__ == "__main__":
    main()
