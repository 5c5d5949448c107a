"""``lrcn-torch generate``, ``eval`` and ``bleu`` against ``lrcn``'s, on
the CPU in f32: from a checkpoint that the JAX CLI trained, both packages
write byte-equal candidates and ids files (Flickr, COCO and no
--datafiles; beam 3 and greedy; the store resident or not), pick the same
ids for ``--sample``, and print the same lines."""

import io
import os

import pytest

from test_torch_cli import (TINY, jax_main, port_main, write_coco_pair,
                            write_flickr)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_generate")
    token, feats = write_flickr(tmp)
    coco = write_coco_pair(tmp, range(10000, 10100),
                           [*range(10100, 10160), 99999])
    ckpt = str(tmp / "jax_ckpt")
    assert jax_main(["train", "--datafiles", token, "--features", feats,
                     "--savefile", ckpt, "--epochs", "2", "--batchsize",
                     "16", "--lr", "3e-3", "--seed", "3", "--dropout", "0.0",
                     *TINY]) == 0
    return {"tmp": tmp, "token": token, "feats": feats, "coco": coco,
            "ckpt": ckpt}


CASES = {
    "flickr": lambda d: ["--datafiles", d["token"]],
    "flickr greedy": lambda d: ["--datafiles", d["token"],
                                "--beam_width", "1"],
    "flickr groups of 16x2, store off": lambda d: [
        "--datafiles", d["token"], "--batch-size", "16", "--scan-depth",
        "2", "--resident-store", "off", "--max-inflight", "1"],
    "coco": lambda d: ["--datafiles", *d["coco"], "--resident-store", "on"],
    "no datafiles": lambda d: ["--capnumber", "30"],
}


def _generate(main, data, extra, tag, capsys):
    out = os.path.join(str(data["tmp"]), f"{tag}_cands")
    ids = os.path.join(str(data["tmp"]), f"{tag}_ids")
    capsys.readouterr()
    assert main(["generate", "--loadfile", data["ckpt"], "--features",
                 data["feats"], "--capnumber", "40", "--generate", "10",
                 "--seed", "3", "--compute-dtype", "float32",
                 "--out", out, "--ids-out", ids, *extra]) == 0
    printed = capsys.readouterr().out.replace(out, "<out>")
    with open(out, "rb") as f, open(ids, "rb") as g:
        return f.read(), g.read(), printed


@pytest.mark.parametrize("case", list(CASES))
def test_generate_files_are_byte_equal(trained, case, capsys):
    extra = CASES[case](trained)
    tag = case.replace(" ", "_").replace(",", "")
    port = _generate(port_main, trained, extra, f"port_{tag}", capsys)
    jax = _generate(jax_main, trained, extra, f"jax_{tag}", capsys)
    assert port[1] == jax[1]             # the same held-out ids
    assert port[0] == jax[0]             # the same captions, byte for byte
    assert port[2] == jax[2]             # the same printed lines
    lines = port[0].decode().splitlines()
    assert len(lines) == port[1].count(b"\n") > 0
    assert len(set(lines)) > 3, lines    # a model that says something


def test_generate_default_names_follow_the_reference(trained, tmp_path,
                                                     monkeypatch):
    """Without --out the Flickr split writes candidates_flickr and
    candidate_ids_flickr (lrcn.jl:133-134), as the JAX CLI does."""
    monkeypatch.chdir(tmp_path)
    assert port_main(["generate", "--loadfile", trained["ckpt"],
                      "--features", trained["feats"], "--datafiles",
                      trained["token"], "--capnumber", "8", "--generate",
                      "6", "--seed", "9", "--compute-dtype",
                      "float32"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["candidate_ids_flickr",
                                            "candidates_flickr"]


def test_sample_picks_the_same_ids(trained, capsys):
    extra = ["--datafiles", trained["token"], "--sample", "4",
             "--temperature", "1.5", "--capnumber", "10"]
    port = _generate(port_main, trained, extra, "port_sample", capsys)
    jax = _generate(jax_main, trained, extra, "jax_sample", capsys)
    assert port[1] == jax[1]
    lines = port[0].decode().splitlines()
    assert len(lines) == len(jax[0].decode().splitlines()) == 10
    assert all(line.endswith(".") for line in lines)
    assert port[2] == jax[2]
    # the same seed draws the same samples in the port
    again = _generate(port_main, trained, extra, "port_sample2", capsys)
    assert again[0] == port[0]


def test_eval_and_bleu_print_what_jax_prints(trained, capsys, monkeypatch):
    tmp = trained["tmp"]
    cands, ids, _ = _generate(jax_main, trained,
                              ["--datafiles", trained["token"]],
                              "jax_eval", capsys)
    cand_path = os.path.join(str(tmp), "jax_eval_cands")
    ids_path = os.path.join(str(tmp), "jax_eval_ids")
    outs = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        refs = str(tmp / f"{name}_refs")
        assert main(["eval", "--candidates", cand_path, "--candidate-ids",
                     ids_path, "--annotations", trained["token"],
                     "--refs-dir", refs]) == 0
        printed = capsys.readouterr().out
        assert printed.startswith("BLEU = ")
        files = {}
        for f in sorted(os.listdir(refs)):
            with open(os.path.join(refs, f), "rb") as fh:
                files[f] = fh.read()
        bleu = []
        for lc in ([], ["--lc"]):
            monkeypatch.setattr("sys.stdin", io.StringIO(cands.decode()))
            assert main(["bleu", os.path.join(refs, "f_ref"), *lc]) == 0
            bleu.append(capsys.readouterr().out)
        outs[name] = (printed, files, bleu)
    assert outs["port"][0] == outs["jax"][0]
    assert outs["port"][1] == outs["jax"][1]
    assert outs["port"][2] == outs["jax"][2]
    assert outs["port"][2][0] == outs["port"][0]
