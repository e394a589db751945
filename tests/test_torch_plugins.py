"""Plugins in the port against the JAX package, on the CPU: fake entry
points (objects with `.name`, `.group`, `.module`, `.dist` and `.load()`)
set in both packages' `_plugin_load_from`, `_plugin_save_to` and
`_plugin_cli` lists, each package given plugins built on its own classes.

Every case runs both `main`s in this process from one directory with a
fresh copy of the inputs, and compares exit codes, stdout, stderr (the
package name aside) and every file byte for byte: a loader plugin read by
`sig cat` and `search`, a saver plugin written by `sig cat`, a command
under `scripts NAME` and `ext NAME`, broken plugins that are skipped, and
`info -v`, which lists them all."""

import json

import numpy as np
import pytest

import sourmash_tpu
import sourmash_tpu_torch
from sourmash_tpu import plugins as jax_plugins
from sourmash_tpu_torch import plugins as torch_plugins
from sourmash_tpu_torch.save_load import SaveSignaturesToLocation
from torch_cli_parity import assert_same, both, isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")

PACKAGES = {"jax": (sourmash_tpu, jax_plugins), "torch": (sourmash_tpu_torch, torch_plugins)}


class FakeEntryPoint:
    "What importlib.metadata gives a plugin: its name, group, module, dist and load()."

    def __init__(self, name, group, target, *, module="fake_sourmash_plugins", version="1.2"):
        self.name, self.group, self.module = name, group, module
        self._target, self._version = target, version

    @property
    def dist(self):
        if self._version is None:
            raise AttributeError("no distribution")
        return type("Dist", (), {"version": self._version})()

    def load(self):
        if isinstance(self._target, Exception):
            raise self._target
        return self._target


def _plugins_of(package):
    """The loader, saver and command plugins of one package, built on its own
    index, saver and CommandLinePlugin classes."""
    from importlib import import_module

    name = package.__name__
    index = import_module(f"{name}.index")
    save_load = import_module(f"{name}.save_load")
    signature = import_module(f"{name}.signature")
    logging = import_module(f"{name}.logging")
    plugins = import_module(f"{name}.plugins")

    def load_fake(location, **kwargs):
        "A '.fake' file is a JSON signature file under another name."
        if not location.endswith(".fake"):
            return None
        with open(location) as fp:
            return index.LinearIndex(list(signature.load_signatures_from_json(fp.read())),
                                     location)

    load_fake.priority = 5

    class SaveFake(save_load.Base_SaveSignaturesToLocation):
        "Write a '.fake' file: a JSON signature file under another name."

        location_suffix = ".fake"
        priority = 5

        def open(self):
            self.keep = []

        def add(self, ss):
            super().add(ss)
            self.keep.append(ss)

        def close(self):
            with open(self.location, "wb") as fp:
                fp.write(signature.save_signatures_to_json(self.keep))

    class Hello(plugins.CommandLinePlugin):
        command = "hello"
        description = "greet a signature file\n\nand say how many sketches it holds"

        def __init__(self, parser):
            super().__init__(parser)
            parser.add_argument("location")

        def main(self, args):
            super().main(args)
            n = sum(1 for _ in package.load_file_as_signatures(args.location))
            logging.notify(f"hello from a plugin: {args.location} holds {n} sketches")
            print(json.dumps({"location": args.location, "sketches": n}))
            return 0

    class NoCommand(plugins.CommandLinePlugin):
        description = "a command plugin that names no command"

    return dict(
        load_from=[FakeEntryPoint("fake_loader", "sourmash.load_from", load_fake),
                   FakeEntryPoint("broken_loader", "sourmash.load_from",
                                  ModuleNotFoundError("no module named 'gone'"), version=None)],
        save_to=[FakeEntryPoint("fake_saver", "sourmash.save_to", SaveFake)],
        cli=[FakeEntryPoint("hello_cmd", "sourmash.cli_script", Hello),
             FakeEntryPoint("missing_cmd", "sourmash.cli_script",
                            AttributeError("module has no attribute 'Missing'")),
             FakeEntryPoint("nameless_cmd", "sourmash.cli_script", NoCommand,
                            module="fake_sourmash_plugins.nameless")],
    )


@pytest.fixture
def with_plugins(monkeypatch):
    """Both packages' plugin lists replaced by fake entry points; the command
    objects the parsers registered are taken out again afterwards."""
    from sourmash_tpu.cli import scripts as jax_scripts
    from sourmash_tpu_torch.cli import scripts as torch_scripts

    for package, plugins in PACKAGES.values():
        fake = _plugins_of(package)
        monkeypatch.setattr(plugins, "_plugin_load_from", fake["load_from"])
        monkeypatch.setattr(plugins, "_plugin_save_to", fake["save_to"])
        monkeypatch.setattr(plugins, "_plugin_cli", fake["cli"])
        # a broken command plugin is reported once a process
        monkeypatch.setattr(plugins, "_plugin_cli_once", False)
    before = [(s, dict(s._extension_dict)) for s in (jax_scripts, torch_scripts)]
    yield
    for scripts, entries in before:
        scripts._extension_dict.clear()
        scripts._extension_dict.update(entries)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(99)
    d = tmp_path_factory.mktemp("plugins")
    params = dict(ksize=31, moltype="DNA", num=0, scaled=1000, seed=42, track_abundance=False)
    core = rng.integers(0, (1 << 64) // 1000, size=300, dtype=np.uint64)
    sigs = [sourmash_tpu_torch.signature_from_arrays(
        params, np.unique(np.r_[core[: 100 + 60 * i],
                                rng.integers(0, (1 << 64) // 1000, size=80, dtype=np.uint64)]),
        name=f"genome {i}") for i in range(4)]
    with SaveSignaturesToLocation(str(d / "q.sig")) as save:
        save.add(sigs[0])
    (d / "db.fake").write_bytes(sourmash_tpu_torch.save_signatures_to_json(sigs[1:]))
    return d


CASES = {
    "sig cat from a loader plugin": [["sig", "cat", "db.fake", "-o", "out.sig"]],
    "search a loader plugin's database": [["search", "q.sig", "db.fake", "-t", "0.05"]],
    "sig cat to a saver plugin": [["sig", "cat", "q.sig", "db.fake", "-o", "out.fake"]],
    "scripts NAME": [["scripts", "hello", "db.fake"]],
    "ext NAME -q": [["ext", "hello", "q.sig", "-q"]],
    "scripts, no command": [["scripts"]],
    "scripts, an unknown command": [["scripts", "bye"]],
    "info -v lists the plugins": [["info", "-v"]],
}


def _same_but_info(outputs, case):
    if "info" not in case:
        assert_same(outputs)
        return
    # info -v differs by design in its dependency lines (test_torch_misc_cli.py)
    for tag in outputs:
        rcs, out, err, files = outputs[tag]
        keep = [line for line in err.splitlines()
                if not line.startswith(("screed", "- loaded from path: ", "jax", "torch"))]
        outputs[tag] = (rcs, out, "\n".join(keep), files)
    assert_same(outputs)


@pytest.mark.parametrize("case", list(CASES))
def test_plugins_are_identical(world, case, with_plugins, tmp_path, monkeypatch, capsys):
    outputs = both(world, CASES[case], tmp_path, monkeypatch, capsys)
    _same_but_info(outputs, case)
    (rc,), out, err, files = outputs["torch"]
    if case.startswith("scripts,"):
        assert rc not in (None, 0) or "greet a signature file" in out, (rc, out, err)
        return
    assert rc in (None, 0), err
    # the broken command plugins are reported once, and skipped
    assert err.count("cannot find or load module for cli_script plugin 'missing_cmd'") == 1
    assert err.count("no command provided by cli_script plugin 'nameless_cmd'") == 1
    if "loader" in case and "sig cat" in case:
        assert len(json.loads(files["out.sig"])) == 3
    if "saver" in case:
        assert len(json.loads(files["out.fake"])) == 4
    if case.startswith(("scripts", "ext")):
        assert json.loads(out)["sketches"] == (3 if "db.fake" in CASES[case][0] else 1)
        assert ("hello from a plugin" in err) == ("-q" not in CASES[case][0])
    if "info" in case:
        for name, version in (("fake_loader", "1.2"), ("broken_loader", "?"),
                              ("fake_saver", "1.2"), ("hello_cmd", "1.2")):
            assert any(name in line and f" {version} " in line for line in err.splitlines())


def test_scripts_help_lists_the_command(world, with_plugins, tmp_path, monkeypatch, capsys):
    "`scripts --help` names each usable command with the first line of its description."
    outputs = both(world, [["scripts", "--help"]], tmp_path, monkeypatch, capsys)
    assert_same(outputs)
    (rc,), out, err, _ = outputs["torch"]
    assert rc == 0
    assert "sourmash scripts hello            - greet a signature file" in out


def test_no_plugins_detected(world, tmp_path, monkeypatch, capsys):
    "With no entry points, `info -v` says so, as the JAX package does."
    for _, plugins in PACKAGES.values():
        for name in ("_plugin_load_from", "_plugin_save_to", "_plugin_cli"):
            monkeypatch.setattr(plugins, name, [])
    outputs = both(world, [["info", "-v"]], tmp_path, monkeypatch, capsys)
    _same_but_info(outputs, "info")
    assert "(no plugins detected)" in outputs["torch"][2]


def test_entry_point_groups_and_priorities():
    "The port reads the reference's entry-point groups at the same default priorities."
    import inspect

    for name in ("sourmash.load_from", "sourmash.save_to", "sourmash.cli_script"):
        assert name in inspect.getsource(torch_plugins)
    assert torch_plugins.DEFAULT_LOAD_FROM_PRIORITY == jax_plugins.DEFAULT_LOAD_FROM_PRIORITY
    assert torch_plugins.DEFAULT_SAVE_TO_PRIORITY == jax_plugins.DEFAULT_SAVE_TO_PRIORITY
