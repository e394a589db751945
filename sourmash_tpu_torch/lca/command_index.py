"""`sourmash lca index`: build an LCA database from a taxonomy
spreadsheet plus signature collections (behavior parity: reference
`src/sourmash/lca/command_index.py`).
"""

from __future__ import annotations

import csv
import os
import sys

from .. import sourmash_args
from ..logging import debug, error, notify, set_quiet
from ..sourmash_args import DEFAULT_LOAD_K, load_file_as_signatures
from . import lca_utils
from .lca_db import LCA_Database


# ----------------------------------------------------------------------
# taxonomy-spreadsheet parsing

def _spreadsheet_columns(start_column):
    "Expected column layout: identifier, skipped cols, then the rank list."
    skipped = ["_skip_"] * (start_column - 2)
    return ["identifiers"] + skipped + list(lca_utils.taxlist())


def _check_headers(first_row, row_headers, force):
    "Warn/abort when the spreadsheet headers disagree with expectations."
    n_disagree = 0
    for column, value in zip(row_headers, first_row):
        if column == "_skip_" or column.lower() == value.lower():
            continue
        notify(f"** assuming column '{value}' is {column} in spreadsheet")
        n_disagree += 1
        if n_disagree > 2:
            error("whoa, too many assumptions. are the headers right?")
            error("expecting {}", ",".join(row_headers))
            if not force:
                sys.exit(-1)
            notify("...continue, because --force was specified.")


def _shorten_ident(ident, split_identifiers, keep_identifier_versions):
    "Optionally strip description + version suffix from an identifier."
    if split_identifiers:
        ident = ident.split(" ")[0]
        if not keep_identifier_versions:
            ident = ident.split(".")[0]
    return ident


def _row_to_ident_lineage(row_headers, row, *, keep_identifier_versions,
                          split_identifiers):
    "Parse one spreadsheet row into (ident, trimmed lineage tuple)."
    from ..tax.tax_utils import LineagePair

    cells = [x for x in zip(row_headers, row) if x[0] != "_skip_"]
    ident = _shorten_ident(
        cells[0][1], split_identifiers, keep_identifier_versions
    )

    lineage = [
        LineagePair(rank, lca_utils.filter_null(name)) for rank, name in cells[1:]
    ]
    while lineage and lineage[-1].name == "unassigned":
        del lineage[-1]
    return ident, tuple(lineage)


def load_taxonomy_assignments(
    filename,
    *,
    delimiter=",",
    start_column=2,
    use_headers=True,
    force=False,
    split_identifiers=False,
    keep_identifier_versions=False,
):
    """Load a taxonomy spreadsheet into ({ident: lineage tuple}, n_rows)."""
    row_headers = _spreadsheet_columns(start_column)
    assignments = {}
    num_rows = n_species = 0

    with open(filename, newline="") as fp:
        reader = csv.reader(fp, delimiter=delimiter)
        if use_headers:
            notify("examining spreadsheet headers...")
            _check_headers(next(iter(reader)), row_headers, force)

        for row in reader:
            if not (row and row[0].strip()):
                continue
            num_rows += 1

            ident, lineage = _row_to_ident_lineage(
                row_headers,
                row,
                split_identifiers=split_identifiers,
                keep_identifier_versions=keep_identifier_versions,
            )
            if not lineage:
                continue

            known = assignments.get(ident)
            if known is not None:
                if known != lineage and not force:
                    raise Exception(f"multiple lineages for identifier {ident}")
            else:
                assignments[ident] = lineage
                n_species += lineage[-1].rank in ("species", "strain")

    # sanity check: taxonomy spreadsheets should mostly resolve to species
    enough_rows = len(assignments) > 50
    if enough_rows and n_species < len(assignments) * 0.2 and not force:
        for msg, fmt in (
            ("", ()),
            ("ERROR: fewer than 20% of lineages have species-level resolution!?", ()),
            ("({} species assignments found, of {} assignments total)",
             (n_species, len(assignments))),
            ("** If this is intentional, re-run the command with -f.", ()),
        ):
            error(msg, *fmt)
        sys.exit(-1)

    return assignments, num_rows


# ----------------------------------------------------------------------
# database building

class _BuildLog:
    "Anomaly bookkeeping while inserting signatures into the LCA database."

    def __init__(self, assignments):
        self.duplicates = set()
        self.no_lineage = []
        self.remnants = set(assignments)  # idents with no signature (yet)
        self.used_lineages = set()
        self.used_idents = set()

    def note_inserted(self, ident, lineage):
        if lineage:
            self.remnants.remove(ident)
            self.used_idents.add(ident)
            self.used_lineages.add(lineage)
        else:
            debug("WARNING: no lineage assignment for {}.", ident)
            self.no_lineage.append(ident)


def generate_report(log, unused_lineages, unused_identifiers, filename):
    "Output a report of anomalies from building the index."
    sections = [
        (f"Duplicate signatures: {len(log.duplicates)}", log.duplicates),
        (f"----\nUnused identifiers: {len(unused_identifiers)}", unused_identifiers),
        (
            f"----\nNo lineage provided for these identifiers: {len(log.no_lineage)}",
            log.no_lineage,
        ),
        (
            f"----\nNo signatures found for these identifiers: {len(log.remnants)}",
            log.remnants,
        ),
    ]
    with open(filename, "w") as fp:
        for title, items in sections:
            print(title, file=fp)
            fp.write("\n".join(items))
            fp.write("\n")
        print(f"----\nUnused lineages: {len(unused_lineages)}", file=fp)
        for lineage in unused_lineages:
            fp.write(";".join(lca_utils.zip_lineage(lineage)))
            fp.write("\n")


def _resolve_db_outfile(args):
    "Apply the format-specific filename suffix; refuse overwrites."
    out = args.lca_db_out
    if args.database_format == "json":
        if not out.endswith((".lca.json", ".lca.json.gz")):
            out += ".lca.json"
    else:
        assert args.database_format == "sql"
        if not out.endswith(".lca.sql"):
            out += ".lca.sql"

    if os.path.exists(out):
        error(f"ERROR: output file {out} already exists. Not overwriting.")
        sys.exit(-1)
    return out


class _DatabaseBuilder:
    "Insert signatures into a fresh LCA_Database, tracking anomalies."

    def __init__(self, args, assignments, moltype, picklist):
        self.args = args
        self.assignments = assignments
        self.picklist = picklist
        self.moltype = moltype
        self.db = LCA_Database(args.ksize, args.scaled, moltype)
        self.log = _BuildLog(assignments)
        self.md5_to_name = {}
        self.n_files = 0
        self.n_skipped = 0

    def _load_one_file(self, filename, file_no, total):
        args = self.args
        sigs = load_file_as_signatures(
            filename,
            ksize=args.ksize,
            select_moltype=self.moltype,
            picklist=self.picklist,
            yield_all_files=args.force,
        )
        for sig in sigs:
            notify("\r\033[K", end="")
            progress = (
                f"\r... loading signature {str(sig)[:30]}"
                f" ({file_no} of {total}); skipped {self.n_skipped} so far"
            )
            notify(progress, end="")
            debug(filename, sig)
            self._insert(sig, filename)

    def _insert(self, sig, filename):
        args, log = self.args, self.log
        md5 = sig.md5sum()
        if md5 in self.md5_to_name:
            debug(
                "WARNING: in file {}, duplicate md5sum: {}; skipping",
                filename,
                md5,
            )
            log.duplicates.add(sig.name)
            return
        self.md5_to_name[md5] = str(sig)

        orig_ident = sig.name or sig.filename
        ident = _shorten_ident(
            orig_ident, args.split_identifiers, args.keep_identifier_versions
        )
        lineage = self.assignments.get(ident)

        if lineage is None and args.require_taxonomy:
            if args.fail_on_missing_taxonomy:
                notify(f"ERROR: no taxonomy found for identifier '{ident}'")
                if args.split_identifiers:
                    notify(f"(Identifier extracted from name: '{orig_ident})')")
                sys.exit(-1)
            debug("(skipping, because --require-taxonomy was specified)")
            self.n_skipped += 1
            return

        try:
            self.db.insert(sig, ident=ident, lineage=lineage)
        except ValueError as e:
            error(
                "ERROR: cannot insert signature '{}' (md5 {}, loaded from '{}') into database.",
                sig,
                md5[:8],
                filename,
            )
            error("ERROR: {}", str(e))
            sys.exit(-1)

        log.note_inserted(ident, lineage)

    def run(self, inp_files):
        total = len(inp_files)
        for file_no, filename in enumerate(inp_files, 1):
            self.n_files = file_no
            self._load_one_file(filename, file_no, total)

        if self.n_skipped:
            notify(
                f"... loaded {total} signatures; skipped {self.n_skipped} because of --require-taxonomy."
            )
        else:
            notify(f"... loaded {total} signatures.")

        if self.n_files == 0:
            error("ERROR: no signatures found. ??")
            sys.exit(1)

        if not self.db.hashvals:
            error("ERROR: no hash values found - are there any signatures?")
            sys.exit(1)
        notify(
            f"loaded {len(self.db.hashvals)} hashes at ksize={self.args.ksize} scaled={self.args.scaled}"
        )


def _summarize_build(args, builder, db_outfile):
    "Post-build accounting: unused lineages/idents, warnings, report file."
    log = builder.log
    all_lineages = set(builder.assignments.values())
    all_idents = set(builder.assignments)

    notify(
        f"{len(log.used_lineages)} assigned lineages out of {len(all_lineages)} distinct lineages in spreadsheet."
    )
    unused_lineages = all_lineages - log.used_lineages

    notify(
        f"{len(log.used_idents)} identifiers used out of {len(all_idents)} distinct identifiers in spreadsheet."
    )
    assert log.used_idents <= all_idents
    unused_identifiers = all_idents - log.used_idents

    builder.db.save(db_outfile, format=args.database_format)

    anomalies = (
        log.duplicates or log.no_lineage or log.remnants or unused_lineages
    )
    if not anomalies:
        return

    warnings = [
        (len(log.duplicates), "WARNING: {} duplicate signatures."),
        (len(log.no_lineage), "WARNING: no lineage provided for {} signatures."),
        (len(log.remnants), "WARNING: no signatures for {} spreadsheet rows."),
        (len(unused_lineages), "WARNING: {} unused lineages."),
        (len(unused_identifiers), "WARNING: {} unused identifiers."),
    ]
    for count, template in warnings:
        if count:
            notify(template.format(count))

    if args.report:
        notify(f"generating a report and saving in '{args.report}'")
        generate_report(log, unused_lineages, unused_identifiers, args.report)
    else:
        notify("(You can use --report to generate a detailed report.)")


def index(args):
    "Main function for building an LCA database."
    if args.start_column < 2:
        error("error, --start-column cannot be less than 2")
        sys.exit(-1)

    set_quiet(args.quiet, args.debug)
    args.scaled = int(args.scaled)
    if args.ksize is None:
        args.ksize = DEFAULT_LOAD_K

    moltype = sourmash_args.calculate_moltype(args, default="DNA")
    picklist = sourmash_args.load_picklist(args)

    db_outfile = _resolve_db_outfile(args)
    notify(f"saving to LCA DB: {format(db_outfile)}")
    notify(
        f"Building LCA database with ksize={args.ksize} scaled={args.scaled} moltype={moltype}."
    )

    tax_opts = dict(
        delimiter="\t" if args.tabs else ",",
        start_column=args.start_column,
        use_headers=not args.no_headers,
        force=args.force,
        split_identifiers=args.split_identifiers,
        keep_identifier_versions=args.keep_identifier_versions,
    )
    assignments, num_rows = load_taxonomy_assignments(args.csv, **tax_opts)

    n_idents = len(assignments)
    n_lineages = len(set(assignments.values()))
    notify(f"{n_idents} distinct identities in spreadsheet out of {num_rows} rows.")
    notify(f"{n_lineages} distinct lineages in spreadsheet out of {num_rows} rows.")

    inp_files = list(args.signatures)
    if args.from_file:
        inp_files += sourmash_args.load_pathlist_from_file(args.from_file)

    builder = _DatabaseBuilder(args, assignments, moltype, picklist)
    builder.run(inp_files)

    if picklist:
        sourmash_args.report_picklist(args, picklist)

    _summarize_build(args, builder, db_outfile)
