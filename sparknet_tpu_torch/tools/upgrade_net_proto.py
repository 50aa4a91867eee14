"""upgrade_net_proto_text / upgrade_net_proto_binary — read a net proto in
any legacy format (V0 nested layers + padding layers, V1 enum layers, old
data-transform fields) and write it back in the current (V2) format
(reference: caffe/tools/upgrade_net_proto_text.cpp,
upgrade_net_proto_binary.cpp; upgrade chain upgrade_proto.cpp:15-50).

Usage:
  python -m sparknet_tpu_torch.tools.upgrade_net_proto IN OUT [--binary]

Input format (text prototxt vs binary protobuf) is sniffed; --binary
selects binary output (the upgrade_net_proto_binary analog, carrying
weight blobs through), otherwise text is written.

The port's own copy of ``sparknet_tpu/tools/upgrade_net_proto.py``, over
the port's ``proto/`` (the wire codec, ``load_net_binaryproto``,
``save_net_prototxt``); it writes the JAX tool's bytes.  Host work: it
runs no kernel and needs no card.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--binary", action="store_true",
                    help="write binary NetParameter (weights preserved)")
    args = ap.parse_args(argv)

    from ..proto import load_net_prototxt, save_net_prototxt
    from ..proto.wireformat import encode

    # sniff by parsing: a text prototxt is essentially never valid wire
    # format (ASCII letters decode as bogus field/wire-type pairs), while
    # binary files routinely contain 0x0a/printable runs — so try the
    # strict binary decoder first and fall back to text on WireError
    from ..proto.caffemodel import load_net_binaryproto
    from ..proto.wireformat import WireError
    try:
        net = load_net_binaryproto(args.input)
    except WireError:
        net = load_net_prototxt(args.input)  # upgrades run in from_pmsg

    if args.binary:
        with open(args.output, "wb") as f:
            f.write(encode(net.to_pmsg(include_blobs=True), "NetParameter"))
    else:
        save_net_prototxt(net, args.output)
    print(f"Wrote upgraded NetParameter to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
