"""draw_net — render a net prototxt as a Graphviz .dot file (reference:
caffe/python/caffe/draw.py + caffe/python/draw_net.py).  Pure text output;
run `dot -Tpng net.dot -o net.png` wherever graphviz exists.

The port's own copy of ``sparknet_tpu/tools/draw_net.py``: the same DOT
text, byte for byte, from the port's ``proto/``.  Host work; ``dot`` runs
only where ``shutil.which`` finds it.

Usage:
  python -m sparknet_tpu_torch.tools.draw_net NET_PROTOTXT OUT_DOT \
      [--rankdir LR|TB] [--phase TRAIN|TEST|ALL]
"""

from __future__ import annotations

import argparse

_LAYER_STYLE = ('shape=record, fillcolor="#6495ED", style=filled')
_DATA_STYLE = ('shape=record, fillcolor="#90EE90", style=filled')
_BLOB_STYLE = ('shape=octagon, fillcolor="#E0E0E0", style=filled')
_DATA_TYPES = {"Data", "ImageData", "WindowData", "HDF5Data", "DummyData",
               "MemoryData", "JavaData", "Input"}


def _label(lp) -> str:
    """Layer node label with key geometry, like draw.py get_layer_label."""
    parts = [lp.name, lp.type]
    if lp.type in ("Convolution", "Deconvolution"):
        p = lp.sub("convolution_param")
        parts.append(f"kernel {p.get('kernel_size', '?')}"
                     f" stride {p.get('stride', 1)}"
                     f" pad {p.get('pad', 0)}")
    elif lp.type == "Pooling":
        p = lp.sub("pooling_param")
        parts.append(f"{p.get('pool', 'MAX')} kernel "
                     f"{p.get('kernel_size', '?')} stride "
                     f"{p.get('stride', 1)}")
    elif lp.type == "InnerProduct":
        parts.append(f"num_output {lp.sub('inner_product_param').get('num_output', '?')}")
    return r"\n".join(str(p) for p in parts)


def net_to_dot(net_param, rankdir: str = "LR") -> str:
    lines = [
        f'digraph "{net_param.name or "net"}" {{',
        f"  rankdir={rankdir};",
    ]
    for lp in net_param.layer:
        style = _DATA_STYLE if lp.type in _DATA_TYPES else _LAYER_STYLE
        lines.append(f'  "L_{lp.name}" [label="{_label(lp)}", {style}];')
    blobs = set()
    for lp in net_param.layer:
        for t in lp.top:
            if t not in blobs:
                blobs.add(t)
                lines.append(f'  "B_{t}" [label="{t}", {_BLOB_STYLE}];')
        for b in lp.bottom:
            if b not in blobs:
                blobs.add(b)
                lines.append(f'  "B_{b}" [label="{b}", {_BLOB_STYLE}];')
    for lp in net_param.layer:
        for b in lp.bottom:
            if b in lp.top:  # in-place layer: annotate, no cycle
                lines.append(f'  "B_{b}" -> "L_{lp.name}" '
                             f'[dir=both, style=dashed];')
            else:
                lines.append(f'  "B_{b}" -> "L_{lp.name}";')
        for t in lp.top:
            if t not in lp.bottom:
                lines.append(f'  "L_{lp.name}" -> "B_{t}";')
    lines.append("}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("net_prototxt")
    ap.add_argument("out_dot")
    ap.add_argument("--rankdir", default="LR", choices=["LR", "TB", "RL", "BT"])
    ap.add_argument("--phase", default="ALL",
                    choices=["TRAIN", "TEST", "ALL"])
    args = ap.parse_args(argv)

    from ..proto import NetState, Phase, load_net_prototxt
    net = load_net_prototxt(args.net_prototxt)
    if args.phase != "ALL":
        net = net.filtered(NetState(Phase[args.phase]))
    with open(args.out_dot, "w") as f:
        f.write(net_to_dot(net, args.rankdir))
    print(f"Wrote {args.out_dot} ({len(net.layer)} layers)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())


# -- pycaffe caffe.draw API (reference: python/caffe/draw.py:180-208) -------

def _as_net_param(caffe_net):
    """Accept a typed NetParameter, a caffe_pb2 NetParameter message, a
    raw PMessage, or prototxt text/path."""
    from ..proto.caffe_pb import NetParameter
    from ..proto.textformat import PMessage
    if isinstance(caffe_net, NetParameter):
        return caffe_net
    pm = getattr(caffe_net, "_p", caffe_net)
    if isinstance(pm, PMessage):
        return NetParameter.from_pmsg(pm)
    from ..proto import load_net_prototxt
    return load_net_prototxt(str(caffe_net))


def draw_net(caffe_net, rankdir: str = "LR", ext: str = "png") -> bytes:
    """Render the net; returns image bytes (draw.py draw_net).  The
    reference renders through pydot+graphviz; here 'dot'/'gv' return the
    Graphviz source directly and image formats shell out to a `dot`
    binary when one exists (a clear error otherwise)."""
    dot_text = net_to_dot(_as_net_param(caffe_net), rankdir)
    if ext in ("dot", "gv"):
        return dot_text.encode()
    import shutil
    import subprocess
    exe = shutil.which("dot")
    if exe is None:
        raise RuntimeError(
            f"rendering {ext!r} needs graphviz's `dot` binary (not "
            f"installed); use ext='dot' for the Graphviz source")
    p = subprocess.run([exe, f"-T{ext}"], input=dot_text.encode(),
                       stdout=subprocess.PIPE, check=True)
    return p.stdout


def draw_net_to_file(caffe_net, filename: str, rankdir: str = "LR") -> None:
    """draw.py draw_net_to_file: extension picks the format."""
    import os
    ext = os.path.splitext(os.path.basename(filename))[1].lstrip(".")
    with open(filename, "wb") as f:
        f.write(draw_net(caffe_net, rankdir, ext or "dot"))
