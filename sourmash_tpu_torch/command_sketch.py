"""'sketch dna', 'sketch protein', 'sketch translate' and 'sketch
fromfile': sequence files -> signatures.

Counterpart of `sourmash_tpu/command_sketch.py`: the parameter-string
parser (`_parse_params_str`), `ComputeParameters`, the signature factory,
`_execute_sketch`, `dna`, `protein`, `translate`, `_compute_individual` /
`_compute_merged`, `_sketch_whole_file`, `_sketch_aa_file` and `fromfile`
with its helpers (`_compute_sigs` through `_summarize_build_plan`). Behavior
parity: reference `src/sourmash/command_sketch.py`; defaults are identical
(dna k=31,scaled=1000,noabund; protein k=10, dayhoff k=16, hp k=42, each
scaled=200,noabund; seed 42).

DNA files are streamed as large concatenated byte batches (records joined
with k-1 'N' bytes) and hashed on the device in one pass per batch and
sketch parameter set (see `ops/sketch.py`). Protein files, and the six
reading frames of DNA files for `translate`, are remapped per moltype,
joined with zero separators and hashed on the device by K3
(`_sketch_aa_file`). The device is the port's default
(`ops.resolve_device()`: CUDA unless SOURMASH_TORCH_DEVICE names the CPU).

`sketch fromfile` builds every (name, parameter set) that its CSVs ask for
and `--already-done` collections lack, one file at a time through the same
whole-file routes as `sketch dna` and `sketch protein` (K1/K2 for genomes,
K3 for proteomes); its signatures, CSVs and console report are
`sourmash_tpu`'s byte for byte.
"""

from __future__ import annotations

import csv
import os
import sys
from collections import Counter, defaultdict, namedtuple
from dataclasses import dataclass

import numpy as np

from . import sourmash_args
from .logging import notify, error, set_quiet, print_results
from .minhash import MinHash
from .signature import MultiSketchSignature
from .sourmash_args import check_scaled_bounds, check_num_bounds
from . import sequence_io

DEFAULT_MMHASH_SEED = 42

DEFAULTS = dict(
    dna="k=31,scaled=1000,noabund",
    protein="k=10,scaled=200,noabund",
    dayhoff="k=16,scaled=200,noabund",
    hp="k=42,scaled=200,noabund",
)


def _value_of(item, key, example, *, number_word=None):
    "Split 'key=value', demanding '=' directly after the key."
    if len(item) < len(key) + 2 or item[len(key)] != "=":
        raise ValueError(f"{key} takes a parameter, e.g. '{example}'")
    raw = item[len(key) + 1 :]
    try:
        return int(raw)
    except ValueError:
        if number_word is None:
            raise
        raise ValueError(f"cannot parse {key}='{raw}' as {number_word}")


def _parse_params_str(params_str):
    "Parse 'k=31,scaled=1000,abund'-style parameter strings."
    moltype = None
    params = {"ksize": []}

    for item in params_str.split(","):
        if item == "abund":
            params["track_abundance"] = True
        elif item == "noabund":
            params["track_abundance"] = False
        elif item in ("protein", "dayhoff", "hp", "dna"):
            moltype = item
        elif item.startswith("k"):
            params["ksize"].append(_value_of(item, "k", "k=31"))
        elif item.startswith("num"):
            if params.get("scaled"):
                raise ValueError("cannot set both num and scaled in a single minhash")
            num = _value_of(item, "num", "num=500", number_word="a number")
            check_num_bounds(num)
            params["num"] = num
            params["scaled"] = 0
        elif item.startswith("scaled"):
            if params.get("num"):
                raise ValueError("cannot set both num and scaled in a single minhash")
            scaled = _value_of(item, "scaled", "scaled=1000", number_word="an integer")
            params["scaled"] = check_scaled_bounds(scaled)
            params["num"] = 0
        elif item.startswith("seed"):
            params["seed"] = _value_of(item, "seed", "seed=42")
        else:
            raise ValueError(f"unknown component '{item}' in params string")

    return moltype, params


@dataclass
class ComputeParameters:
    """Sketch-template configuration (reference `cmd.rs:22-130` semantics;
    ksizes here are stored ALREADY multiplied by 3 for protein moltypes,
    matching the serialized ksize in .sig files)."""

    ksizes: tuple = (21, 31, 51)
    seed: int = DEFAULT_MMHASH_SEED
    protein: bool = False
    dayhoff: bool = False
    hp: bool = False
    dna: bool = True
    num_hashes: int = 500
    track_abundance: bool = False
    scaled: int = 0

    def __post_init__(self):
        # the CLI passes scaled through a float bounds check; the stored
        # template value is integral (reference keeps it as u64)
        self.scaled = int(self.scaled)
        self.ksizes = list(self.ksizes)

    @classmethod
    def from_args(cls, args):
        """Build from an argparse namespace, copying any matching fields
        (reference command_compute.py:483-494)."""
        from dataclasses import fields as _fields

        ret = cls()
        names = {f.name for f in _fields(cls)}
        for arg, value in vars(args).items():
            if arg in names:
                setattr(ret, arg, value)
        ret.scaled = int(ret.scaled)
        ret.ksizes = list(ret.ksizes)
        return ret

    @property
    def moltype(self):
        if self.dna:
            return "DNA"
        if self.protein:
            return "protein"
        if self.dayhoff:
            return "dayhoff"
        assert self.hp, "exactly one moltype flag must be set"
        return "hp"

    def to_param_str(self):
        "Render as a parameter string (reference `command_sketch.py:926-963`)."
        # first moltype flag wins, in the reference's priority order
        for flag in ("dna", "protein", "hp", "dayhoff"):
            if getattr(self, flag):
                tokens = [flag]
                break
        else:
            assert 0

        kdiv = 1 if self.dna else 3
        tokens += [f"k={k // kdiv}" for k in self.ksizes]

        if self.num_hashes != 0:
            tokens.append(f"num={self.num_hashes}")
        elif self.scaled != 0:
            tokens.append(f"scaled={int(self.scaled)}")
        if self.track_abundance:
            tokens.append("abund")
        if self.seed != DEFAULT_MMHASH_SEED:
            tokens.append(f"seed={self.seed}")
        return ",".join(tokens)

    @classmethod
    def from_manifest_row(cls, row):
        """Convert a manifest row into a ComputeParameters object
        (reference `command_sketch.py:893-930`)."""
        molt = row["moltype"]
        assert molt in ("DNA", "protein", "hp", "dayhoff")
        is_dna = molt == "DNA"
        return cls(
            ksizes=[row["ksize"] if is_dna else row["ksize"] * 3],
            seed=DEFAULT_MMHASH_SEED,
            protein=molt == "protein",
            dayhoff=molt == "dayhoff",
            hp=molt == "hp",
            dna=is_dna,
            num_hashes=row["num"],
            track_abundance=bool(row["with_abundance"]),
            scaled=int(row["scaled"]),
        )

    def make_minhashes(self):
        """Build minhashes per ksize. Multiple moltype flags may be set at
        once (legacy 'compute' computes DNA+protein together); emission
        order per k is protein, dayhoff, hp, dna — reference
        `cmd.rs:108-180` build_template."""
        out = []
        for k in self.ksizes:
            for molt_flag, kwargs in (
                (self.protein, dict(is_protein=True)),
                (self.dayhoff, dict(dayhoff=True)),
                (self.hp, dict(hp=True)),
            ):
                if molt_flag:
                    out.append(
                        MinHash(
                            self.num_hashes,
                            k // 3,
                            track_abundance=self.track_abundance,
                            seed=self.seed,
                            scaled=int(self.scaled),
                            **kwargs,
                        )
                    )
            if self.dna:
                out.append(
                    MinHash(
                        self.num_hashes,
                        k,
                        track_abundance=self.track_abundance,
                        seed=self.seed,
                        scaled=int(self.scaled),
                    )
                )
        return out


def signature_from_params(params: ComputeParameters):
    "Build an (empty, multi-sketch) signature from compute parameters."
    mhs = params.make_minhashes()
    return MultiSketchSignature(mhs)


class _signatures_for_sketch_factory:
    "Build signature templates on demand, per 'sketch' CLI configuration."

    def __init__(self, params_str_list, default_moltype):
        # per-moltype defaults come from parsing the DEFAULTS param strings
        # themselves (they carry no moltype token by construction)
        self.defaults = {
            moltype: _parse_params_str(pstr)[1]
            for moltype, pstr in DEFAULTS.items()
        }
        self.mult_ksize_by_3 = True
        self.params_list = [
            (self._resolve_moltype(mt, default_moltype, pstr), params)
            for mt, params, pstr in (
                (*_parse_params_str(p), p) for p in params_str_list or ()
            )
        ] or [(self._resolve_moltype(None, default_moltype, ""), {})]

    @staticmethod
    def _resolve_moltype(override, default, params_str):
        """Reconcile a param string's moltype token with the command's
        moltype: a dna command rejects protein-family overrides (and vice
        versa), and SOME moltype must come from one of the two."""
        if override and override != "dna" and default == "dna":
            raise ValueError(
                f"Incompatible sketch type ({default}) and parameter override ({override}) in '{params_str}'; maybe use 'sketch translate'?"
            )
        if override == "dna" and default and default != "dna":
            raise ValueError(
                f"Incompatible sketch type ({default}) and parameter override ({override}) in '{params_str}'"
            )
        if override is None:
            if default is None:
                raise ValueError(
                    "No default moltype and none specified in param string"
                )
            return default
        return override

    def get_compute_params(self, *, split_ksizes=False):
        for moltype, params_d in self.params_list:
            default_params = self.defaults[moltype]
            def_seed = default_params.get("seed", DEFAULT_MMHASH_SEED)
            def_num = default_params.get("num", 0)
            def_abund = default_params["track_abundance"]
            def_scaled = default_params.get("scaled", 0)
            def_dna = moltype == "dna"

            ksizes = params_d.get("ksize")
            if not ksizes:
                ksizes = default_params["ksize"]

            if self.mult_ksize_by_3 and not def_dna:
                ksizes = [k * 3 for k in ksizes]

            def make_param(ksizes):
                return ComputeParameters(
                    ksizes=tuple(ksizes),
                    seed=params_d.get("seed", def_seed),
                    protein=moltype == "protein",
                    dayhoff=moltype == "dayhoff",
                    hp=moltype == "hp",
                    dna=def_dna,
                    num_hashes=params_d.get("num", def_num),
                    track_abundance=params_d.get("track_abundance", def_abund),
                    scaled=params_d.get("scaled", def_scaled),
                )

            if split_ksizes:
                for ksize in ksizes:
                    yield make_param([ksize])
            else:
                yield make_param(ksizes)

    def __call__(self, *, split_ksizes=False):
        "Produce a fresh set of signature templates."
        return [
            signature_from_params(params)
            for params in self.get_compute_params(split_ksizes=split_ksizes)
        ]


def _add_from_file_to_filenames(args):
    from .sourmash_args import load_pathlist_from_file

    if args.from_file:
        args.filenames.extend(load_pathlist_from_file(args.from_file))


def _bail(*messages, code=-1):
    "Print error line(s) and exit."
    for msg in messages:
        error(msg)
    sys.exit(code)


def _read_failure(filename, exc):
    "Exact console shape for a sequence-read error, then exit."
    _bail(f"ERROR when reading from '{filename}' - ", str(exc))


def _close_save_sigs(save_sigs):
    "Close a signature sink and report the exact console line."
    save_sigs.close()
    notify(
        f"saved {len(save_sigs)} signature(s) to '{save_sigs.location}'. Note: signature license is CC0."
    )


def _execute_sketch(args, signatures_factory):
    "Shared sketch runner for dna/protein/translate."
    set_quiet(args.quiet)

    if not args.filenames:
        _bail("error: no input filenames provided! nothing to do - exiting.")
    if args.license != "CC0":
        _bail("error: sourmash only supports CC0-licensed signatures. sorry!")

    notify(f'computing signatures for files: {", ".join(args.filenames)}')

    if args.merge and not args.output:
        _bail("ERROR: must specify -o with --merge")
    if args.output and args.output_dir:
        _bail("ERROR: --output-dir doesn't make sense with -o/--output")

    num_sigs = len(signatures_factory.params_list)
    notify(f"Computing a total of {num_sigs} signature(s) for each input.")
    if num_sigs == 0:
        _bail("...nothing to calculate!? Exiting!")

    runner = _compute_merged if args.merge else _compute_individual
    runner(args, signatures_factory)


def _run_sketch(args, default_moltype):
    "Common tail of the sketch commands."
    from .ops import resolve_device

    resolve_device()  # no CUDA device and no SOURMASH_TORCH_DEVICE=cpu: fail now
    try:
        signatures_factory = _signatures_for_sketch_factory(
            args.param_string, default_moltype
        )
    except ValueError as e:
        error(f"Error creating signatures: {str(e)}")
        sys.exit(-1)

    _add_from_file_to_filenames(args)
    _execute_sketch(args, signatures_factory)


def _protein_family_moltype(args):
    "Resolve --dayhoff/--hp flags for the protein-output commands."
    if args.dayhoff and args.hp:
        raise ValueError("cannot set both --dayhoff and --hp")
    if args.dayhoff:
        return "dayhoff"
    if args.hp:
        return "hp"
    return "protein"


def dna(args):
    "Compute a DNA signature for one or more files."
    args.input_is_protein = False
    _run_sketch(args, "dna")


def protein(args):
    "Compute a protein signature for one or more files."
    args.input_is_protein = True
    args.check_sequence = False
    _run_sketch(args, _protein_family_moltype(args))


def translate(args):
    "Compute protein signatures from DNA/RNA input."
    args.input_is_protein = False
    _run_sketch(args, _protein_family_moltype(args))


# -- sketch fromfile --------------------------------------------------------

# the port's copies of `sourmash_tpu/sig/__main__.py:_SketchInfo` and
# `_summarize_manifest`
_SketchInfo = namedtuple("_SketchInfo", "ksize, moltype, scaled, num, abund")


def _summarize_manifest(manifest):
    "Summary dict of sketch types in a manifest (reference :1283-1313)."
    kinds = Counter()
    kind_hashes = Counter()
    total_size = 0
    for row in manifest.rows:
        ski = _SketchInfo(
            ksize=row["ksize"],
            moltype=row["moltype"],
            scaled=row["scaled"],
            num=row["num"],
            abund=row["with_abundance"],
        )
        kinds[ski] += 1
        kind_hashes[ski] += row["n_hashes"]
        total_size += row["n_hashes"]

    return dict(
        total_hashes=total_size,
        sketch_info=[
            dict(ski._asdict(), count=count, n_hashes=kind_hashes[ski])
            for ski, count in kinds.items()
        ],
    )


def _compute_sigs(to_build, output, *, check_sequence=False):
    """Build the signatures in 'to_build' and save them to 'output'
    (reference `command_sketch.py:309-362`). Each file goes through the
    whole-file route of `sketch dna|protein` (`_sketch_whole_file`), whose
    sketches equal the reference's record-by-record add_seq loop."""
    from .ops import resolve_device

    resolve_device()  # no CUDA device and no SOURMASH_TORCH_DEVICE=cpu: fail now
    save_sigs = sourmash_args.SaveSignaturesToLocation(output)
    save_sigs.open()

    for (name, filename), param_objs in to_build.items():
        assert param_objs

        sigs = []
        is_dna = param_objs[0].dna
        for p in param_objs:
            if p.dna:
                assert is_dna
            sigs.append(signature_from_params(p))

        input_is_protein = not is_dna

        notify(f"... reading sequences from {filename}")
        try:
            n, _first = _sketch_whole_file(sigs, filename, input_is_protein, check_sequence)
        except ValueError as exc:
            _read_failure(filename, exc)
        if n is None:
            error(f"ERROR: no sequences found in '{filename}'?!")
            sys.exit(-1)

        # the reference reports the last record's index
        notify("...{} {} sequences", filename, n - 1, end="")
        set_sig_name(sigs, filename, name)
        for sig in sigs:
            save_sigs.add(sig)

    _close_save_sigs(save_sigs)


def _output_csv_info(filename, sigs_to_build):
    "Output info needed to construct signatures, in CSV (reference :365-400)."
    with sourmash_args.FileOutputCSV(filename) as csv_fp:
        w = csv.DictWriter(
            csv_fp,
            fieldnames=["filename", "sketchtype", "output_index", "name", "param_strs"],
        )
        w.writeheader()

        output_n = 0
        for (name, filename_), param_objs in sigs_to_build.items():
            param_strs = []

            if param_objs[0].dna:
                assert all(p.dna for p in param_objs)
                sketchtype = "dna"
            else:
                assert not any(p.dna for p in param_objs)
                sketchtype = "protein"

            for p in param_objs:
                param_strs.append(p.to_param_str())

            w.writerow(
                dict(
                    filename=filename_,
                    sketchtype=sketchtype,
                    param_strs="-p " + " -p ".join(param_strs),
                    name=name,
                    output_index=output_n,
                )
            )
            output_n += 1


def _read_build_requests(csvfiles, report_duplicated):
    """Read fromfile CSVs into {name: (genome, proteome)}; abort on blank
    or duplicate names."""
    all_names = {}
    total_rows = 0
    n_missing_name = 0
    duplicate_names = set()
    n_duplicate_name = 0

    for csvfile in csvfiles:
        with sourmash_args.FileInputCSV(csvfile) as r:
            for row in r:
                name = row["name"]
                if not name:
                    n_missing_name += 1
                    continue

                total_rows += 1
                if name in all_names:
                    n_duplicate_name += 1
                    duplicate_names.add(name)
                else:
                    all_names[name] = (row["genome_filename"], row["protein_filename"])

    problems = []
    if n_duplicate_name:
        if report_duplicated:
            notify("duplicated:\n" + "\n".join(sorted(duplicate_names)))
        problems.append(
            f"** ERROR: {n_duplicate_name} entries have duplicate 'name' records. Exiting!"
        )
    if n_missing_name:
        problems.append(f"** ERROR: {n_missing_name} entries have blank 'name's? Exiting!")
    if problems:
        _bail(*problems)

    return all_names, total_rows


def _load_already_done(locations, all_names, build_params):
    """Index pre-built sketches by name; collect manifest rows matching a
    requested (name, params) combination."""
    from .manifest import CollectionManifest
    from .save_load import load_file_as_index

    already_done = defaultdict(list)
    matching_rows = []
    for filename in locations:
        idx = load_file_as_index(filename)
        manifest = idx.manifest
        assert manifest

        for row in manifest.rows:
            name = row["name"]
            if not name:
                continue
            p = ComputeParameters.from_manifest_row(row)
            already_done[name].append(p)
            if name in all_names and p in build_params:
                matching_rows.append(row)

    already_done_manifest = CollectionManifest(matching_rows)
    if locations:
        notify(f"Loaded {len(already_done)} pre-existing names from manifest(s)")
        notify(f"collected {len(matching_rows)} rows for already-done signatures.")
    return already_done, already_done_manifest


def _print_sketch_type_summary(entries):
    "One formatted line per sketch type; entries = (ski, count, n_hashes|None)."
    for ski, count, n_hashes in entries:
        ksize = ski["ksize"] if isinstance(ski, dict) else ski.ksize
        moltype = ski["moltype"] if isinstance(ski, dict) else ski.moltype
        num = ski["num"] if isinstance(ski, dict) else ski.num
        scaled = ski["scaled"] if isinstance(ski, dict) else ski.scaled
        abund = ski["abund"] if isinstance(ski, dict) else ski.abund

        mh_type = f"num={num}" if num else f"scaled={scaled}"
        mh_abund = ", abund" if abund else ""
        sketch_str = f"{count} sketches with {moltype}, k={ksize}, {mh_type}{mh_abund}"
        if n_hashes is None:
            print_results(f"   {sketch_str: <50}")
        else:
            print_results(f"   {sketch_str: <50} {n_hashes} total hashes")


def _fromfile_build_params(args):
    "Validate fromfile preconditions and return the split-ksize param list."
    if args.license != "CC0":
        _bail("error: sourmash only supports CC0-licensed signatures. sorry!")

    output = args.output_signatures
    if output and os.path.exists(output) and not args.force_output_already_exists:
        _bail(
            f"** ERROR: output location '{output}' already exists!",
            "** Not overwriting/appending.",
            "** Use --force-output-already-exists if you want to overwrite/append.",
        )

    try:
        sig_factory = _signatures_for_sketch_factory(args.param_string, None)
    except ValueError as e:
        _bail(f"Error creating signatures: {str(e)}")

    build_params = list(sig_factory.get_compute_params(split_ksizes=True))
    if any(p.seed != DEFAULT_MMHASH_SEED for p in build_params):
        _bail("** ERROR: cannot set 'seed' in 'sketch fromfile'")
    return build_params


def _plan_builds(all_names, build_params, already_done):
    """Plan every (name, params) combination not already built.

    Returns (to_build, missing, counts dict) where counts carries
    total/skipped/missing tallies for the console report."""
    to_build = defaultdict(list)
    missing = defaultdict(list)
    tally = dict(total=0, skipped=0, missing=0)

    for name, (genome, proteome) in all_names.items():
        done_here = already_done.get(name, [])
        for p in build_params:
            tally["total"] += 1
            src = genome if p.dna else proteome
            if p in done_here:
                tally["skipped"] += 1
            elif src:
                to_build[(name, src)].append(p)
            else:
                filetype = "genome" if p.dna else "proteome"
                notify(f"WARNING: fromfile entry '{name}' is missing a {filetype}")
                missing[name].append(p)
                tally["missing"] += 1
    return to_build, missing, tally


def _report_already_done(args, already_done_manifest):
    "Console block for pre-existing sketches + optional manifest output."
    if already_done_manifest:
        info_d = _summarize_manifest(already_done_manifest)
        print_results("---")
        print_results("summary of already-done sketches:")
        _print_sketch_type_summary(
            (ski, ski["count"], ski["n_hashes"]) for ski in info_d["sketch_info"]
        )
        print_results("---")

    out_loc = args.output_manifest_matching
    if out_loc:
        already_done_manifest.write_to_filename(out_loc)
        notify(
            f"output {len(already_done_manifest)} already-done signatures to '{out_loc}' in manifest format."
        )


def _report_missing(missing, n_missing, ignore_missing):
    "Console block for unbuildable requests; exits unless --ignore-missing."
    error("** ERROR: we cannot build some of the requested signatures.")
    error(
        f"** {n_missing} total signatures (for {len(missing)} names) cannot be built."
    )
    if not ignore_missing:
        sys.exit(-1)
    error("** (continuing past this error because --ignore-missing was set)")


def _summarize_build_plan(to_build):
    "Console block summarizing the sketch types about to be built."
    print_results("---")
    print_results("summary of sketches to build:")

    counter = Counter()
    for param_objs in to_build.values():
        for p in param_objs:
            assert len(p.ksizes) == 1
            counter[
                _SketchInfo(
                    ksize=p.ksizes[0] if p.dna else p.ksizes[0] // 3,
                    moltype=p.moltype,
                    scaled=p.scaled,
                    num=p.num_hashes,
                    abund=p.track_abundance,
                )
            ] += 1

    _print_sketch_type_summary((ski, count, None) for ski, count in counter.items())
    print_results("---")


def fromfile(args):
    """Build sketches for many named genomes/proteomes listed in CSV(s)
    (reference `command_sketch.py:403-633`)."""
    build_params = _fromfile_build_params(args)
    all_names, total_rows = _read_build_requests(args.csvs, args.report_duplicated)
    already_done, already_done_manifest = _load_already_done(
        args.already_done, all_names, build_params
    )

    to_build, missing, tally = _plan_builds(all_names, build_params, already_done)
    total_sigs = tally["total"]
    skipped_sigs = tally["skipped"]

    notify(f"Read {total_rows} rows, requesting that {total_sigs} signatures be built.")
    _report_already_done(args, already_done_manifest)
    if missing:
        _report_missing(missing, tally["missing"], args.ignore_missing)

    n_new = total_sigs - skipped_sigs
    notify(f"** {n_new} new signatures to build from {len(to_build)} files;")
    if not to_build:
        notify("** Nothing to build. Exiting!")
        sys.exit(0)
    if skipped_sigs:
        notify(f"** {skipped_sigs} already exist, so skipping those.")
    else:
        notify("** we found no pre-existing signatures that match.")

    _summarize_build_plan(to_build)

    if args.output_signatures:
        _compute_sigs(
            to_build, args.output_signatures, check_sequence=args.check_sequence
        )
    if args.output_csv_info:
        _output_csv_info(args.output_csv_info, to_build)

    notify(
        f"** {total_sigs} total requested; output {n_new}, skipped {skipped_sigs}"
    )


def _read_stdin_bytes():
    "Slurp stdin into a seekable buffer (handles text-only stdin stand-ins)."
    import io as _io

    stdin = sys.stdin
    if hasattr(stdin, "buffer"):
        data = stdin.buffer.read()
    else:
        data = stdin.read()
        if isinstance(data, str):
            data = data.encode("utf-8")
    return _io.BytesIO(data)


def add_seq(sigs, seq, input_is_protein, check_sequence):
    "Add one sequence record into all signatures."
    for sig in sigs:
        if input_is_protein:
            sig.add_protein(seq)
        else:
            sig.add_sequence(seq, not check_sequence)


def set_sig_name(sigs, filename, name=None):
    if filename == "-":
        filename = ""
    for sig in sigs:
        if name is not None:
            sig._name = name
        sig._filename = filename


def save_siglist(siglist, sigfile_name):
    "Save multiple signatures to a filename."
    with sourmash_args.SaveSignaturesToLocation(sigfile_name) as save_sig:
        for ss in siglist:
            save_sig.add(ss)
        notify(f"saved {len(save_sig)} signature(s) to '{save_sig.location}'")


def save_sigs_to_location(siglist, save_sig):
    "Save multiple signatures to an already-open location."
    for ss in siglist:
        save_sig.add(ss)


def _add_records(sigs, filename, input_is_protein, check_sequence):
    "Per-record add_seq over one file: (n_records, first_name) or (None, None)."
    n = None
    first_name = None
    for n, (name, seq) in enumerate(sequence_io.iter_records_bytes(filename)):
        if n == 0:
            first_name = name
        add_seq(sigs, seq, input_is_protein, check_sequence)
    if n is None:
        return None, None
    return n + 1, first_name


def _sketch_whole_file(sigs, filename, input_is_protein, check_sequence):
    """Batched sketching of one file into `sigs` (device path).

    Returns (n_records, first_record_name) or (None, None) if empty.
    Semantics identical to per-record add_seq: DNA records are joined with
    k-1 'N' separators (invalid windows dropped); with check_sequence,
    records are validated individually first. Protein input, and translate
    without --check-sequence, go through `_sketch_aa_file`; translate with
    --check-sequence sketches record by record.
    """
    from .ops import encodings as enc
    from .ops.sketch import seq_chunks_to_hashes
    from .minhash import MINHASH_MAX_HASH

    if input_is_protein:
        if not check_sequence:
            return _sketch_aa_file(sigs, filename, translate=False)
        return _add_records(sigs, filename, True, check_sequence)

    # translate path (DNA input, protein-family targets)
    mhs = [mh for sig in sigs for mh in sig._all_minhashes()]
    if any(not mh.is_dna for mh in mhs):
        if not check_sequence and not any(mh.is_dna for mh in mhs):
            return _sketch_aa_file(sigs, filename, translate=True)
        return _add_records(sigs, filename, False, check_sequence)

    # DNA path: batch records per target minhash config.
    # group target minhashes by (ksize, seed): one device pass per group.
    targets = defaultdict(list)  # (ksize, seed) -> list of MinHash
    for sig in sigs:
        for mh in sig._all_minhashes():
            targets[(mh.ksize, mh.seed)].append(mh)

    max_ksize = max(k for (k, _) in targets)

    n = None
    first_name = None
    batches = []
    for names, joined in sequence_io.iter_record_batches(filename, max_ksize):
        if n is None and names:
            first_name = names[0]
        n = (n or 0) + len(names)
        if check_sequence:
            # separators are 'N' bytes; valid records contain only ACGT
            # find invalid chars that are not separator-injected
            # simplest exact check: validate each record separately
            for rname, rseq in zip(names, _split_joined(joined, names, max_ksize)):
                rarr = enc.upper(np.frombuffer(rseq, dtype=np.uint8))
                bad = ~enc.VALID_DNA[rarr]
                if bad.any():
                    i = int(np.argmax(bad))
                    start = max(0, i - max_ksize + 1)
                    kmer = rseq[start : start + max_ksize].decode("ascii", "replace")
                    raise ValueError(
                        f"invalid DNA character in input k-mer: {kmer}"
                    )
        batches.append(joined)

    if n is None:
        return None, None

    for (ksize, seed), mh_list in targets.items():
        # distinct max_hash values within the group share hash computation
        by_maxhash = defaultdict(list)
        for mh in mh_list:
            key = mh._max_hash if mh._max_hash else MINHASH_MAX_HASH
            by_maxhash[key].append(mh)
        for max_hash, mhs in by_maxhash.items():
            all_hashes = []
            for joined in batches:
                hs = seq_chunks_to_hashes(joined, ksize, int(max_hash), seed)
                all_hashes.append(hs)
            if all_hashes:
                flat = np.concatenate(all_hashes)
                for mh in mhs:
                    mh._insert_hashes(flat)

    return n, first_name


_AA_FLUSH_BYTES = 32 << 20  # aa bytes buffered per target before a device flush


def _sketch_aa_file(sigs, filename, *, translate: bool):
    """Batched device sketching of a protein (or translate) file: every
    record's amino-acid stream (six frames per record when translating) is
    remapped per moltype on the host, joined with zero separators and
    hashed by K3 in as few launches as possible; windows that cross a
    separator are invalid and dropped. Hash-multiset-identical to the
    per-record add_protein/add_sequence loop (the reference's per-record
    SeqToHashes, `signature.rs:307-393`)."""
    from .ops import encodings as enc
    from .ops.sketch import aa_chunks_to_hashes

    # mh.ksize is the amino-acid k (ComputeParameters stores it times 3)
    targets = defaultdict(list)  # (aa_ksize, seed, moltype) -> [MinHash]
    for sig in sigs:
        for mh in sig._all_minhashes():
            targets[(mh.ksize, mh.seed, mh.moltype)].append(mh)

    # remapped frame streams accumulate per target and flush every
    # _AA_FLUSH_BYTES: insertion is incremental, so files larger than RAM
    # stream through
    pending = {key: [] for key in targets}
    pending_n = dict.fromkeys(targets, 0)

    def flush(key):
        streams = pending[key]
        if not streams:
            return
        k, seed, _moltype = key
        sep = np.zeros(k, dtype=np.uint8)
        parts = []
        for fr in streams:
            parts.append(fr)
            parts.append(sep)
        joined = np.concatenate(parts[:-1])
        hashes = aa_chunks_to_hashes(joined, k, seed, mask_invalid=True)
        for mh in targets[key]:
            mh._insert_hashes(hashes)
        pending[key] = []
        pending_n[key] = 0

    n_records = 0
    first_name = None
    for name, seq in sequence_io.iter_records_bytes(filename):
        if n_records == 0:
            first_name = name
        n_records += 1
        arr = enc.upper(np.frombuffer(seq, dtype=np.uint8))
        if translate:
            rc = enc.revcomp(arr)
            frames = [
                enc.translate_frame(s)
                for frame in range(3)
                for s in (arr[frame:], rc[frame:])
            ]
        else:
            frames = [arr]
        for key in targets:
            k, _seed, moltype = key
            for fr in frames:
                if fr.shape[0] >= k:
                    # remap BEFORE joining: the zero separator must stay
                    # invalid (dayhoff and hp map byte 0 to a class byte)
                    pending[key].append(enc.remap_aa(fr, moltype))
                    pending_n[key] += fr.shape[0]
            if pending_n[key] >= _AA_FLUSH_BYTES:
                flush(key)

    if n_records == 0:
        return None, None
    for key in targets:
        flush(key)
    return n_records, first_name


def _split_joined(joined: bytes, names, ksize: int):
    "Split a separator-joined batch back into records."
    sep = b"N" * (ksize - 1)
    if len(names) == 1:
        return [joined]
    return joined.split(sep)


def _compute_individual(args, signatures_factory):
    save_sigs = None
    open_output_each_time = not args.output

    for filename in args.filenames:
        # stdin can only be read once; buffer it so peek + sketch both work
        read_obj = filename
        if filename == "-":
            read_obj = _read_stdin_bytes()
        if open_output_each_time:
            sigfile = os.path.basename(filename) + ".sig"
            if args.output_dir:
                sigfile = os.path.join(args.output_dir, sigfile)

            if os.path.exists(sigfile) and not args.force:
                notify("skipping {} - already done", filename)
                continue

            assert not save_sigs
            save_sigs = sourmash_args.SaveSignaturesToLocation(sigfile)

        # peek: empty file?
        try:
            peek = next(iter(sequence_io.iter_records_bytes(read_obj)), None)
        except (OSError, ValueError) as exc:
            _read_failure(filename, exc)
        if peek is None:
            notify(f"no sequences found in '{filename}'?!")
            continue

        if open_output_each_time:
            save_sigs.open()
        elif save_sigs is None:
            # the single -o sink opens lazily on the first nonempty input
            save_sigs = sourmash_args.SaveSignaturesToLocation(args.output)
            save_sigs.open()

        if args.singleton:
            n_calculated = 0
            n = 0
            for n, (rname, rseq) in enumerate(
                sequence_io.iter_records_bytes(read_obj)
            ):
                sigs = signatures_factory()
                try:
                    add_seq(sigs, rseq, args.input_is_protein, args.check_sequence)
                except ValueError as exc:
                    _read_failure(filename, exc)

                n_calculated += len(sigs)
                set_sig_name(sigs, filename, name=rname)
                save_sigs_to_location(sigs, save_sigs)

            notify(
                "calculated {} signatures for {} sequences in {}",
                n_calculated, n + 1, filename,
            )
        else:
            sigs = signatures_factory()
            notify(f"... reading sequences from {filename}")
            try:
                n, first_name = _sketch_whole_file(
                    sigs, read_obj, args.input_is_protein, args.check_sequence
                )
            except ValueError as exc:
                _read_failure(filename, exc)

            name = first_name if args.name_from_first else None
            set_sig_name(sigs, filename, name)
            save_sigs_to_location(sigs, save_sigs)

            notify(
                f"calculated {len(sigs)} signatures for {n} sequences in {filename}"
            )

        if open_output_each_time:
            _close_save_sigs(save_sigs)
            save_sigs = None

    if args.output and save_sigs is not None:
        _close_save_sigs(save_sigs)


def _compute_merged(args, signatures_factory):
    sigs = signatures_factory()

    total_seq = 0
    for filename in args.filenames:
        read_obj = filename
        if filename == "-":
            read_obj = _read_stdin_bytes()
        notify("... reading sequences from {}", filename)
        try:
            n, _ = _sketch_whole_file(
                sigs, read_obj, args.input_is_protein, args.check_sequence
            )
        except ValueError as exc:
            _read_failure(filename, exc)
        if n is not None:
            notify("... {} {} sequences", filename, n)
            total_seq += n
        else:
            notify(f"no sequences found in '{filename}'?!")

    if not total_seq:
        return
    set_sig_name(sigs, filename, name=args.merge)
    notify(
        "calculated 1 signature for {} sequences taken from {} files",
        total_seq,
        len(args.filenames),
    )
    save_siglist(sigs, args.output)
